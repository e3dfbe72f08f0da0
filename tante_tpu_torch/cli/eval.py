"""Evaluation CLI (counterpart of ``tante_tpu/cli/eval.py``).

    python -m tante_tpu_torch.cli.eval --config-name=tante [--choose=best] [--device cpu] [key=value ...]

The data's eval window is forced to the evaler's rollout length
(``data.eval_steps_output = evaler.n_steps_rollout``); the evaler restores
the ``--choose`` checkpoint of the experiment and prints its report over the
test split.  ``--device`` (default: the card) goes to the datamodule, the
model and the evaler.
"""

from __future__ import annotations

import argparse
import logging

from tante_tpu_torch.config import instantiate, load_config, set_ckpt
from tante_tpu_torch.utils.logging import MetricLogger
from tante_tpu_torch.utils.seeding import set_seed

logger = logging.getLogger("tante_tpu_torch.eval")


def main(argv=None):
    """Runs an evaluation; returns its report (for callers in the same process)."""
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-name", default="tante")
    parser.add_argument("--config-dir", default=None)
    parser.add_argument("--choose", default="recent", choices=["recent", "best"])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)

    cfg = load_config(args.config_name, config_dir=args.config_dir, overrides=args.overrides)
    cfg.data.eval_steps_output = cfg.evaler.n_steps_rollout
    cfg, checkpoint_folder = set_ckpt(cfg, choose=args.choose)

    set_seed(cfg.seed)
    device = args.device

    logger.info("Instantiate datamodule %s", cfg.data._target_)
    datamodule = instantiate(cfg.data, seed=cfg.seed, device=device)
    dset_metadata = datamodule.train_dataset.metadata
    print(dset_metadata)

    logger.info("Instantiate model %s", cfg.model._target_)
    model = instantiate(cfg.model, dset_metadata=dset_metadata, seed=cfg.seed, device=device)

    logger.info("Instantiate evaler %s", cfg.evaler._target_)
    evaler = instantiate(
        cfg.evaler,
        checkpoint_folder=checkpoint_folder,
        model=model,
        datamodule=datamodule,
        batch_size=cfg.data.batch_size,
        metric_logger=MetricLogger(checkpoint_folder),
        device=device,
    )
    report = evaler.Eval(mode="common")
    print(report)
    return report


if __name__ == "__main__":
    main()
