"""Metric suite on torch tensors (counterpart of ``tante_tpu/train/metrics.py``).

All spatial metrics take channels-last ``(B, T, *spatial, C)`` tensors and
reduce over the spatial dims, keeping ``[B, T, C]``; 3-D fields
``(B, T, D, H, W, C)`` reduce over (D, H, W).

Call contract: ``metric(x, y, rt)`` returns the spatial loss tensor when
``rt is None``; otherwise ``spatial.mean() + eval_rt(rt, eps, n, band_hi)``,
the adaptive trainer's r_t band penalty (only MSE defines ``eval_rt``).
"""

from __future__ import annotations

import math

import torch


def _spatial_axes(x: torch.Tensor) -> tuple:
    """All dims between T and C."""
    return tuple(range(2, x.ndim - 1))


class Metric:
    """Base class; subclasses define ``eval`` (+ optionally ``eval_rt``)."""

    def __call__(self, x, y, rt=None, eps: float = 0.5, n: float = 2.0, band_hi: float = 4.0):
        loss_spatial = self.eval(x, y)
        if rt is not None:
            return loss_spatial.mean() + self.eval_rt(rt, eps, n, band_hi)
        return loss_spatial

    @staticmethod
    def eval(x, y):  # pragma: no cover - abstract
        raise NotImplementedError

    @staticmethod
    def eval_rt(rt, eps, n, band_hi=4.0):  # pragma: no cover - abstract
        raise NotImplementedError


class MSE(Metric):
    @staticmethod
    def eval(x, y):
        return ((x - y) ** 2).mean(dim=_spatial_axes(x))  # [B, T, C]

    @staticmethod
    def eval_rt(rt, eps=0.5, n=2.0, band_hi=4.0):
        """Band penalty pulling mean r_t into [1 + eps, band_hi]
        (``band_hi = 4.0`` is the reference's hardcoded anchor)."""
        beta1, beta2 = 5e-3, 1e-1
        rt_avg = rt.mean()
        up = min(1.0 + eps, band_hi)
        down = max(1.0 + eps, band_hi)
        low = torch.clamp(up - rt_avg, min=0.0)
        high = torch.clamp(rt_avg - down, min=0.0)
        return beta1 * low**n + beta2 * high**n


def _norm(y: torch.Tensor, dims: tuple, norm_mode: str) -> torch.Tensor:
    if norm_mode == "norm":
        return (y**2).mean(dim=dims)
    if norm_mode == "std":
        return y.var(dim=dims, unbiased=True)
    raise ValueError(f"Invalid norm_mode: {norm_mode}")


class NMSE(Metric):
    @staticmethod
    def eval(x, y, eps: float = 1e-7, norm_mode: str = "norm"):
        return MSE.eval(x, y) / (_norm(y, _spatial_axes(y), norm_mode) + eps)


class L2RE(Metric):
    @staticmethod
    def eval(x, y, eps: float = 1e-7):
        # Flatten (T, H, W) per (B, C): vector-norm ratio.
        b, c = x.shape[0], x.shape[-1]
        xf, yf = x.reshape(b, -1, c), y.reshape(b, -1, c)
        num = torch.linalg.norm(xf - yf, dim=1)
        den = torch.linalg.norm(yf, dim=1) + eps
        return num / den  # [B, C]


class NNMSE(Metric):
    @staticmethod
    def eval(x, y, eps: float = 1e-7, norm_mode: str = "norm"):
        norm = _norm(y, tuple(range(2, y.ndim)), norm_mode)  # over (*spatial, C)
        return MSE.eval(x, y).mean(dim=-1) / (norm + eps)  # [B, T]


class RMSE(Metric):
    @staticmethod
    def eval(x, y):
        return torch.sqrt(MSE.eval(x, y))


class NRMSE(Metric):
    @staticmethod
    def eval(x, y, eps: float = 1e-7, norm_mode: str = "norm"):
        return torch.sqrt(NMSE.eval(x, y, eps=eps, norm_mode=norm_mode))


class VMSE(Metric):
    @staticmethod
    def eval(x, y):
        return NMSE.eval(x, y, norm_mode="std")


class VRMSE(Metric):
    """The Well's VRMSE (= NRMSE with variance normalization)."""

    @staticmethod
    def eval(x, y):
        return NRMSE.eval(x, y, norm_mode="std")


# --------------------------------------------------------------------------
# Data-complexity diagnostics: exported but unused by the trainers.
# --------------------------------------------------------------------------


def _temporal_psd(tensor: torch.Tensor) -> torch.Tensor:
    mean = tensor.mean(dim=1, keepdim=True)
    std = tensor.std(dim=1, keepdim=True, unbiased=False)
    fft = torch.fft.fft((tensor - mean) / (std + 1e-10), dim=1)
    return (fft.conj() * fft).real


def compute_spectral_entropy(tensor: torch.Tensor):
    """Temporal-FFT spectral entropy over (B, T, H, W, C)."""
    psd = _temporal_psd(tensor)
    p = psd / (psd.sum(dim=1, keepdim=True) + 1e-10)
    ent = -(p * torch.log(p + 1e-10)).sum(dim=1)
    ent_norm = ent / (math.log(psd.shape[1]) + 1e-10)
    return float(ent.mean()), float(ent_norm.mean())


def compute_high_frequency_ratio(tensor: torch.Tensor, cutoff=(0.2, 0.5, 0.8)):
    psd = _temporal_psd(tensor)
    total = psd.sum(dim=1, keepdim=True)
    num_freqs = psd.shape[1]
    out = []
    for thresh in cutoff:
        hi_power = psd[:, int(thresh * num_freqs):].sum(dim=1)
        # squeeze() as the JAX package does: it drops every size-1 dim.
        out.append(float((hi_power / (total.squeeze() + 1e-10)).mean()))
    return out


def complexity_metrics(data: torch.Tensor, cutoff=(0.2, 0.5, 0.8)):
    se, se_norm = compute_spectral_entropy(data)
    hfr = compute_high_frequency_ratio(data, cutoff=cutoff)
    return {"spectral_entropy": (se, se_norm), "highfreq_ratio": hfr}
