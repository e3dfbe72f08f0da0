"""The config layer (counterpart of ``tante_tpu/config.py``): per-model YAML
files with ``_target_`` trees, recursive instantiation, dotted overrides
(``a.b.c=value``), ``--config-name`` selection, and the run-time changes the
CLIs make (the checkpoint resolution of ``set_ckpt``, eval's
``eval_steps_output``).

``CONFIG_DIR`` is the repository's ``configs/``, read in place: the JAX
package and the port share one set of YAML files, and the reference names in
them resolve to the port's classes (``registry.py``).  ``yaml`` is imported
where it is used.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

from tante_tpu_torch.registry import resolve

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


class Config(dict):
    """A dict with attribute access and dotted get/set."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def select(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def update_dotted(self, dotted: str, value: Any) -> None:
        node: Any = self
        parts = dotted.split(".")
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self) -> Dict[str, Any]:
        return _unwrap(self)

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def copy(self) -> "Config":
        return _wrap(copy.deepcopy(_unwrap(self)))


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def _unwrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _unwrap(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unwrap(v) for v in obj]
    return obj


def _parse_value(text: str) -> Any:
    """An override's value with YAML's reading (ints, floats, bools, lists)."""
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def load_config(config_name: str, config_dir: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> Config:
    """``<config_dir>/<config_name>.yaml`` (or a path ending in .yaml) with
    the dotted ``key=value`` overrides applied in order."""
    import yaml

    config_dir = config_dir or CONFIG_DIR
    path = (config_name if config_name.endswith((".yaml", ".yml"))
            else os.path.join(config_dir, config_name + ".yaml"))
    with open(path) as f:
        cfg = _wrap(yaml.safe_load(f) or {})
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' is not of the form key=value")
        key, _, val = ov.partition("=")
        cfg.update_dotted(key.strip(), _parse_value(val.strip()))
    return cfg


def instantiate(node: Any, **extra_kwargs: Any) -> Any:
    """Build a ``_target_`` node: its child nodes first, depth first, then
    the target with the node's keys and ``extra_kwargs`` (which override
    them) as arguments.  Dicts and lists without a target are walked; other
    values pass through."""
    if isinstance(node, dict) and "_target_" in node:
        ctor = resolve(node["_target_"])
        kwargs = {k: instantiate(v) for k, v in node.items() if k != "_target_"}
        kwargs.update(extra_kwargs)
        return ctor(**kwargs)
    if isinstance(node, dict):
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


def set_ckpt(cfg: Config, choose: str = "recent") -> tuple:
    """-> (cfg, experiment folder).  The folder is
    ``<root_path>/experiments/<experiment>`` (made if missing, as an absolute
    path); if it holds a ``<choose>`` checkpoint (``recent/`` or ``best/``, a
    directory holding ``state.pt``, ``utils/checkpoint.py``), its path goes to
    ``cfg.trainer.checkpoint_path`` and ``cfg.evaler.checkpoint_path``, else
    "" does: the trainer then starts fresh, and resumes otherwise."""
    experiment_folder = os.path.abspath(
        os.path.join(cfg["root_path"], "experiments", cfg["experiment"]))
    checkpoint_path = ""
    if os.path.exists(experiment_folder):
        candidate = os.path.join(experiment_folder, choose)
        if os.path.isdir(candidate):
            checkpoint_path = candidate
    else:
        os.makedirs(experiment_folder, exist_ok=True)
    if "trainer" in cfg:
        cfg["trainer"]["checkpoint_path"] = checkpoint_path
    if "evaler" in cfg:
        cfg["evaler"]["checkpoint_path"] = checkpoint_path
    return cfg, experiment_folder
