"""Chain timing and inputs shared by the decode-GEMV probes.

:func:`chain_us` is the counterpart of the ``measure`` functions of the JAX
package's ``scripts/kernel_attrib.py`` and ``scripts/pipelined_gemv.py``:
per-call device microseconds by differencing two chain lengths (8 and 40
calls).  Call ``i`` of a chain reads layer ``i`` of a stack, so the
weights come from device memory and not from the 50 MB L2.  Each chain
is captured in one CUDA graph and replayed between two CUDA events; the
best of 3 replays is kept.  The TPU differenced chains to remove its
host dispatch; here the difference removes the graph launch and the
first node's latency.

:func:`random_stack` draws a layer stack in the serving layout (K padded
to whole superblocks, N to the lane tile: gateup N 22016 -> 22528, down K
11008 -> 11264), from a seeded generator on the target device.
"""

from __future__ import annotations

import torch

from ..core.bitpack import pick_superblock_padded, wrap_int32
from ..models.stacked import _pick_lane_pad

#: decode sites of Llama-2-7B as (N, K): fused qkv, o, fused gateup, down
SITES = {"o": (4096, 4096), "qkv": (12288, 4096), "gu": (22016, 4096),
         "down": (4096, 11008)}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
CHAIN_LENS = (8, 40)
REPLAYS = 3
#: wrapper launches of one chain_us: per length an eager chain and the
#: captured one (graph replays launch nothing from Python)
CHAIN_LAUNCHES = 2 * sum(CHAIN_LENS)


def random_stack(N, K, nbits, L, gen, device):
    """``(packed [L, Kp*b/32, Np] int32, scale, zero [L, Kp/128, Np] bf16,
    superblock)``: random words, scale in [0, 0.02), zero in [0, 2^b - 1),
    in the serving layout."""
    sb, k_pad = pick_superblock_padded(K)
    Kp, Np = K + k_pad, N + _pick_lane_pad(N)
    packed = torch.empty((L, Kp * nbits // 32, Np), dtype=torch.int32,
                         device=device)
    for i in range(L):        # one layer at a time: the int64 draw is 2x
        packed[i] = wrap_int32(torch.randint(
            0, 2**32, packed.shape[1:], dtype=torch.int64, device=device,
            generator=gen))
    scale = (torch.rand((L, Kp // 128, Np), generator=gen, device=device)
             * 0.02).to(torch.bfloat16)
    zero = (torch.rand((L, Kp // 128, Np), generator=gen, device=device)
            * (2**nbits - 1)).to(torch.bfloat16)
    return packed, scale, zero, sb


def weight_bytes(packed, scale, N) -> int:
    """Bytes of one layer's packed words and scale/zero over the N columns
    the kernels read: K padded to whole superblocks, while the lane pad
    past N is never fetched (the kernels launch ceil(N / tile) column
    tiles, and N is a multiple of the tile at every 7B site)."""
    return (packed.shape[-2] * N * packed.element_size()
            + 2 * scale.shape[-2] * N * scale.element_size())


def bound_us(packed, scale, N) -> float:
    """The byte bound of one layer: its weight bytes over 3.35 TB/s."""
    return weight_bytes(packed, scale, N) / HBM_BYTES_PER_S * 1e6


def graph_ms(run, replays=REPLAYS) -> float:
    """Device ms of ``run()``: one eager call (first-call set-up), then
    ``run()`` captured in a CUDA graph and replayed between two events;
    the best of ``replays``."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return min(times)


def chain_us(call, lens=CHAIN_LENS) -> float:
    """Device microseconds per call of ``call(i)`` (which launches on layer
    ``i``): :func:`graph_ms` of chains of ``lens[0]`` and ``lens[1]``
    calls, differenced over ``lens[1] - lens[0]`` calls."""
    ms = [graph_ms(lambda n=n: [call(i) for i in range(n)]) for n in lens]
    return (ms[1] - ms[0]) * 1e3 / (lens[1] - lens[0])


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1e-30)
