"""The port's CUDA kernels held to their plain versions on a card.

Marked ``cuda``: they skip without a card (the kernels have no CPU mode).
This file imports no JAX, so it also runs where only PyTorch is installed
(``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from amq_tpu_torch.core import quantize as tq
from amq_tpu_torch.ops import decode_attention as tda
from amq_tpu_torch.ops import quant_matmul as tqm


def _norm_close(got, want, atol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
@pytest.mark.parametrize("M", [1, 3, 64])
def test_cuda_quant_matmul_matches_plain(nbits, M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(60 + nbits + M)
    N, K = 320, 1152
    W = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32) * 0.02)
    qt = tq.quantize(W.cuda(), nbits=nbits, meta_dtype=torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).cuda()
    u = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).cuda()
    kw = dict(nbits=nbits, group_size=128, shape=(N, K),
              superblock=qt.superblock, out_dtype=torch.float32)
    got = tqm.quant_matmul_swiglu_indexed(x, u, qt.packed[None], qt.scale[None],
                                          qt.zero[None], 0, **kw)
    want = tqm.qmm_plain(x, qt.packed, qt.scale, qt.zero, up=u, **kw)
    torch.cuda.synchronize()
    _norm_close(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4)


@pytest.mark.cuda
def test_cuda_decode_attention_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    B, Hkv, G, hd, T = 4, 8, 4, 128, 200
    q = torch.randn(B, Hkv, G, hd, generator=g, device="cuda")
    kc, vc = (torch.randn(2, B, Hkv, T, hd, generator=g, device="cuda")
              for _ in range(2))
    kn, vn = (torch.randn(B, Hkv, hd, generator=g, device="cuda")
              for _ in range(2))
    offs = torch.tensor([1, 63, 64, 199], dtype=torch.int32, device="cuda")
    for window in (None, 16):
        got = tda.decode_attention_indexed(q, kc, vc, kn, vn, offs, 1,
                                           window=window, out_dtype=torch.float32)
        want = tda.decode_attention_plain(q, kc[1], vc[1], kn, vn, offs,
                                          window, torch.float32)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
