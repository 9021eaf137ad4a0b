"""Shared CLI plumbing for the port's entry points (the subset the speed
CLI needs: ``base_parser``, ``load_model --synthetic``, ``dump_json``)."""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Tuple

import torch

from ..core.device import resolve_device
from ..models.config import get_config
from ..models.llama import init_params


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--model_name", type=str, default="tiny-llama",
                   help="registry name (e.g. Llama-2-7b-hf)")
    p.add_argument("--model_path", type=str, default="",
                   help="local HF checkpoint dir (not yet ported)")
    p.add_argument("--synthetic", action="store_true",
                   help="random weights drawn from --seed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--group_size", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    return p


def load_model(args) -> Tuple[Any, Dict[str, Any]]:
    """(cfg, dense bf16 params).

    The JAX package keeps the dense params on the host because a 16 GB
    TPU chip cannot hold them beside the proxies; the 80 GB card can, so
    they are drawn directly on the device from a ``torch.Generator``
    seeded with ``--seed``.
    """
    if args.model_path:
        raise NotImplementedError(
            "--model_path (HF checkpoint loading, models/hf.py in the JAX "
            "package) is not yet ported; use --synthetic")
    cfg = get_config(args.model_name)
    if not args.synthetic:
        raise SystemExit("pass --synthetic to run with random weights")
    device = resolve_device()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    return cfg, init_params(cfg, gen, dtype=torch.bfloat16, device=device)


def dump_json(obj, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)
    print(f"wrote {path}")
