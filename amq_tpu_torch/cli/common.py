"""Shared CLI plumbing for the port's entry points: the common flags,
``load_model`` (a local HF checkpoint directory with ``--model_path``,
else random weights with ``--synthetic``), ``proxy_factories``
(``--proxy_path``), ``load_tokens`` and ``dump_json``."""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.config import get_config
from ..models.llama import init_params


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--model_name", type=str, default="tiny-llama",
                   help="registry name (e.g. Llama-2-7b-hf)")
    p.add_argument("--model_path", type=str, default="",
                   help="local HF checkpoint dir (safetensors + config.json)")
    p.add_argument("--synthetic", action="store_true",
                   help="random weights drawn from --seed, synthetic tokens")
    p.add_argument("--dataset", type=str, default="wikitext2",
                   help="wikitext2 | c4 | synthetic | local:<text file>")
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--n_sample", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--group_size", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="evaluation forward dtype")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu for "
                        "the plain PyTorch path")
    p.add_argument("--data_parallel", action="store_true",
                   help="split evaluation samples over the ranks of the "
                        "process group (this process is one rank; started "
                        "by a launcher such as torchrun, which sets RANK, "
                        "WORLD_SIZE, MASTER_ADDR and MASTER_PORT)")
    p.add_argument("--dist_backend", type=str, default="",
                   choices=("", "nccl", "gloo"),
                   help="the process group's backend, needed with "
                        "--data_parallel unless the group is already up")
    return p


def data_group(args):
    """The process group evaluation splits its samples over
    (``--data_parallel``), or None.  Joins the group from the launcher's
    environment when it is not up yet; the backend is ``--dist_backend``,
    never picked here."""
    if not getattr(args, "data_parallel", False):
        return None
    import torch.distributed as dist
    if not dist.is_initialized():
        if not args.dist_backend:
            raise SystemExit("--data_parallel needs --dist_backend (nccl or "
                             "gloo) to join the process group")
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world == 1:
            return None                   # one process: nothing to split
        from ..parallel import multihost
        multihost.initialize(num_processes=world,
                             process_id=int(os.environ["RANK"]),
                             backend=args.dist_backend, init_method="env://")
    return dist.group.WORLD


def is_writer(args) -> bool:
    """Whether this process writes the CLI's files: always, except the
    ranks other than 0 of a data-parallel run (they compute the same
    numbers)."""
    if not getattr(args, "data_parallel", False):
        return True
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def setup_torch() -> None:
    """Float32 products in full float32 and bf16 products reduced in
    float32 (the JAX ``preferred_element_type`` numerics)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def compute_dtype(args) -> torch.dtype:
    return getattr(torch, args.compute_dtype)


def load_model(args) -> Tuple[Any, Dict[str, Any]]:
    """(cfg, dense bf16 params) on ``--device``: the checkpoint directory
    ``--model_path``, else random weights drawn from a ``torch.Generator``
    seeded with ``--seed`` (``--synthetic``).

    The JAX package keeps the dense params on the host because a 16 GB
    TPU chip cannot hold them beside the proxies; the 80 GB card can.
    """
    device = resolve_device(args.device)
    if args.model_path and os.path.isdir(args.model_path):
        from ..models.hf import config_from_hf, load_hf_params
        cfg = config_from_hf(args.model_path)
        return cfg, load_hf_params(args.model_path, cfg, dtype=torch.bfloat16,
                                   device=device)
    cfg = get_config(args.model_name)
    if not args.synthetic:
        raise SystemExit(f"no checkpoint at {args.model_path!r}; pass "
                         "--synthetic to run with random weights")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    return cfg, init_params(cfg, gen, dtype=torch.bfloat16, device=device)


def proxy_path(root: str, cfg, nbits: int, group_size: int) -> str:
    """Where the proxy CLI writes the ``nbits`` proxy of ``cfg``."""
    return os.path.join(root, f"{cfg.name}_{nbits}bit_{group_size}gs_1axis")


def proxy_factories(args, cfg, bits_range=(2, 3, 4)) -> List[Callable]:
    """Per-bit loaders of the proxies under ``--proxy_path`` (each read
    straight to ``--device`` when called, so a consumer holds one at a
    time)."""
    from ..utils.checkpoint import load_quantized
    device = resolve_device(args.device)
    return [(lambda b=b: load_quantized(
        proxy_path(args.proxy_path, cfg, b, args.group_size),
        device=device)[0]) for b in bits_range]


def load_tokens(args, cfg, train: bool = True) -> np.ndarray:
    """``[n_sample, seqlen]`` int32 tokens of ``--dataset`` (synthetic under
    ``--synthetic`` unless a local file is named)."""
    from ..evaluation import data as data_mod
    if args.dataset == "synthetic" or (
            args.synthetic and not args.dataset.startswith("local:")):
        return data_mod.synthetic_tokens(cfg.vocab_size,
                                         n_sample=args.n_sample,
                                         seqlen=args.seqlen, seed=args.seed)
    from ..models.hf import load_tokenizer
    try:
        tok = load_tokenizer(args.model_path or args.model_name)
    except ImportError as e:
        raise SystemExit("the `transformers` package is needed for a "
                         "tokenizer and is not installed; use --synthetic") from e
    return data_mod.get_loader(args.dataset, tokenizer=tok,
                               n_sample=args.n_sample, train=train,
                               seed=args.seed, seqlen=args.seqlen)


def dump_json(obj, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)
    print(f"wrote {path}")
