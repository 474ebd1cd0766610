"""CLI entry point: ``python -m microaligner_tpu_torch config.yaml``.

PyTorch counterpart of ``microaligner_tpu/__main__.py``: one positional
argument, the YAML config path, with the JAX package's schema.  It runs on
the first CUDA device and raises when there is none; it never falls back to
the CPU.  ``main(argv, device=...)`` runs it in process on another device
(the tests use ``device="cpu"``).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from pprint import pprint
from typing import Optional, Sequence

from microaligner_tpu_torch.pipeline.config import PipelineConfigReader
from microaligner_tpu_torch.pipeline.runner import run_pipeline
from microaligner_tpu_torch.utils.device import resolve_device


def parse_cmd_args(argv: Optional[Sequence[str]] = None) -> Path:
    parser = argparse.ArgumentParser(
        description="microaligner_tpu_torch: image registration for large scale microscopy "
                    "on an NVIDIA GPU (PyTorch + CUDA)"
    )
    parser.add_argument("config", type=Path, help="path to the config yaml file")
    return parser.parse_args(argv).config


def main(argv: Optional[Sequence[str]] = None, device="cuda"):
    device = resolve_device(device)
    print("Started\n")
    config_path = parse_cmd_args(argv)
    config = PipelineConfigReader().read_config(config_path)
    print("The input config is:")
    pprint(config, sort_dicts=False, indent=2)
    run_pipeline(config, device)


if __name__ == "__main__":
    main()
