"""The port's verification and study tools, the counterparts of the
JAX package's `scripts/`: each runs as ``python -m
bithtm_tpu_torch.scripts.<name>`` with the JAX script's flags and
defaults, on the card unless ``--device cpu`` is given, and each has a
``main(argv)`` that prints its report and returns it as a dict.

  parity_check         full-step oracle parity (`tpu_parity_check.py`)
  profile_step         device time a step by call site (`profile_step.py`)
  soak_fast_stack      convergence soak of the bench fast stack
  soak_16k_autocap     16K x 64 learning under `htm_scan_autocap`
  soak_evict_pressure  sustained column-pool pressure under "evict"
  grow_variants        what holds `grow_select` back: variants of its
                       source timed in turns (card only)
"""

from __future__ import annotations

import argparse

import torch


def add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")


def pick_device(name: str) -> torch.device:
    """``name`` as a device; the card must be present if it is named."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "false); pass --device cpu to run on the CPU")
    return dev


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
