"""Training CLI (counterpart of ``tante_tpu/cli/train.py``).

    python -m tante_tpu_torch.cli.train --config-name=tante [--device cpu] [key=value ...]

Flow: load the config with the overrides, resolve the experiment folder and
the checkpoint to resume from (``recent/``), seed, then instantiate the
datamodule, the model, the optimizer, the LR schedule, the metric logger and
the trainer, write ``extended_config.yaml``, and train up to
``trainer.max_epoch``.  ``--device`` (default: the card) goes to the
datamodule, the model and the trainer.
"""

from __future__ import annotations

import argparse
import logging
import os.path as osp

from tante_tpu_torch.config import instantiate, load_config, set_ckpt
from tante_tpu_torch.utils.logging import MetricLogger
from tante_tpu_torch.utils.seeding import set_seed

logger = logging.getLogger("tante_tpu_torch.train")


def main(argv=None):
    """Runs a training; returns the trainer (for callers in the same process)."""
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-name", default="tante")
    parser.add_argument("--config-dir", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)

    cfg = load_config(args.config_name, config_dir=args.config_dir, overrides=args.overrides)
    cfg, checkpoint_folder = set_ckpt(cfg, choose="recent")
    print(cfg.to_yaml())

    set_seed(cfg.seed)
    device = args.device

    logger.info("Instantiate datamodule %s", cfg.data._target_)
    datamodule = instantiate(cfg.data, seed=cfg.seed, device=device)
    dset_metadata = datamodule.train_dataset.metadata
    print(dset_metadata)

    logger.info("Instantiate model %s", cfg.model._target_)
    model = instantiate(cfg.model, dset_metadata=dset_metadata, seed=cfg.seed, device=device)

    logger.info("Instantiate optimizer %s", cfg.optimizer._target_)
    optimizer = instantiate(cfg.optimizer)

    logger.info("Instantiate LR scheduler %s", cfg.lr_scheduler._target_)
    lr_scheduler = instantiate(
        cfg.lr_scheduler,
        max_epochs=cfg.trainer.max_epoch,
        lr=cfg.optimizer.lr,
        warmup_start_lr=cfg.optimizer.lr * 0.1,
        eta_min=cfg.optimizer.lr * 0.1,
    )

    metric_logger = MetricLogger(
        checkpoint_folder,
        project=cfg.get("wandb_project_name"),
        group=cfg.data.get("dataset_name"),
        name=cfg.get("experiment"),
        config=cfg.to_dict(),
        use_wandb=bool(cfg.get("use_wandb", False)),
    )

    logger.info("Instantiate trainer %s", cfg.trainer._target_)
    trainer = instantiate(
        cfg.trainer,
        checkpoint_folder=checkpoint_folder,
        model=model,
        datamodule=datamodule,
        optimizer=optimizer,
        lr_scheduler=lr_scheduler,
        seed=cfg.seed,
        metric_logger=metric_logger,
        device=device,
    )
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.info("Model parameters: %s", f"{n_params:,}")

    with open(osp.join(checkpoint_folder, "extended_config.yaml"), "w") as f:
        f.write(cfg.to_yaml())

    trainer.train()
    metric_logger.finish()
    return trainer


if __name__ == "__main__":
    main()
