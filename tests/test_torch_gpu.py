"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: 2e-5 in fp32; in bf16 4e-3 plus 8e-3 relative, one bf16 ulp
of the output (both sides compute in fp32 and differ only in the final
rounding); the gather and the fused norm's residual sum are bit-equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels.compaction import fused_compact, gather_rows  # noqa: E402
from repro_torch.kernels.compaction.ref import (  # noqa: E402
    compact_reference, gather_rows_reference)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_reference, flash_attention)
from repro_torch.kernels.ragged_decode_attention import (  # noqa: E402
    decode_attention_reference, ragged_decode_attention)
from repro_torch.kernels.rmsnorm import fused_rmsnorm, rmsnorm_reference  # noqa: E402

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=4e-3, rtol=8e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed):
    g = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return torch.from_numpy(g).to(dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d", [(4, 1000, 16, 2, 128),
                                          (2, 256, 8, 1, 128),
                                          (3, 130, 32, 4, 128),
                                          (16, 2048, 16, 2, 128)])
def test_ragged_kernel_matches_plain(cuda, b, s, hq, hkv, d, dtype):
    q = _randn((b, hq, d), dtype, cuda, 0)
    kc = _randn((b, s, hkv, d), dtype, cuda, 1)
    vc = _randn((b, s, hkv, d), dtype, cuda, 2)
    ln = torch.from_numpy(np.linspace(1, s, b).astype(np.int32)).to(cuda)
    before = K.LAUNCHES["ragged_decode_attention"]
    out = ragged_decode_attention(q, kc, vc, ln)
    assert K.LAUNCHES["ragged_decode_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(),
                               decode_attention_reference(q, kc, vc, ln).float(),
                               **TOL[dtype])


@pytest.mark.gpu
def test_ragged_kernel_rejects_what_it_does_not_take(cuda):
    q = _randn((2, 6, 128), torch.float32, cuda, 0)
    kc = _randn((2, 64, 2, 128), torch.float32, cuda, 1)
    ln = torch.tensor([3, 64], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="built for"):    # G = 3
        ragged_decode_attention(q, kc, kc, ln)
    q64 = _randn((2, 16, 64), torch.float32, cuda, 0)
    k64 = _randn((2, 64, 2, 64), torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="built for"):    # D = 64
        ragged_decode_attention(q64, k64, k64, ln)
    with pytest.raises(TypeError):                        # mixed dtypes
        ragged_decode_attention(q[:, :4].contiguous().half(), kc, kc, ln)
    with pytest.raises(ValueError):                       # CPU + CUDA
        ragged_decode_attention(q[:, :4].contiguous(), kc, kc, ln.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32,
                                   torch.uint8])
@pytest.mark.parametrize("shape", [(3, 8, 65), (2, 16, 4, 3, 5), (36, 16, 2048)])
def test_gather_kernel_bit_equal(cuda, dtype, shape):
    src = (_randn(shape, torch.float32, cuda, 3) * 100).to(dtype)
    idx = torch.tensor([7, 0, 0, 3], dtype=torch.int32, device=cuda)
    before = K.LAUNCHES["gather_rows"]
    out = gather_rows(src, idx)
    assert K.LAUNCHES["gather_rows"] == before + 1
    assert torch.equal(out, gather_rows_reference(src, idx))


@pytest.mark.gpu
def test_fused_compact_bit_equal_to_host_gathers(cuda):
    cache = {"pos0": {k: _randn((2, 8, 32, 2, 64), torch.bfloat16, cuda, i)
                      for i, k in enumerate("kv")}}
    kv_lens = torch.arange(8, dtype=torch.int32, device=cuda) + 5
    tok = torch.arange(8, dtype=torch.int32, device=cuda) * 7
    produced = torch.tensor([4, 1, 4, 0, 2, 4, 4, 4], dtype=torch.int32,
                            device=cuda)
    targets = torch.full((8,), 4, dtype=torch.int32, device=cuda)
    c, l, t, _, keep = fused_compact(cache, kv_lens, tok, None, produced,
                                     targets, nb=4)
    assert keep.tolist() == [1, 3, 4, 0]
    rc, rl, rt, _ = compact_reference(cache, kv_lens, tok, keep)
    for a, b in ((c["pos0"]["k"], rc["pos0"]["k"]),
                 (c["pos0"]["v"], rc["pos0"]["v"]), (l, rl), (t, rt)):
        assert torch.equal(a, b)


# prompt lengths that are no block multiple among them; B = 16 with S = 4096
# is left out only because the plain version's [B, H, S, S] scores would
# take 17 GB
FLASH_SHAPES = [(b, s, None) for s in (16, 80, 192, 256, 1000) for b in (1, 16)] \
    + [(1, 4096, None), (2, 1000, 256), (16, 192, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,win", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, b, s, win, dtype):
    q = _randn((b, s, 16, 128), dtype, cuda, 0)
    k = _randn((b, s, 2, 128), dtype, cuda, 1)
    v = _randn((b, s, 2, 128), dtype, cuda, 2)
    before = K.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=win)
    assert K.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(
        out.float(), attention_reference(q, k, v, window=win).float(),
        **TOL[dtype])


@pytest.mark.gpu
def test_flash_kernel_reads_strided_bshd_views(cuda):
    """q, k and v as views of one fused projection: read through their
    strides, no copy."""
    qkv = _randn((2, 80, 20, 128), torch.bfloat16, cuda, 3)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:18], qkv[:, :, 18:]
    torch.testing.assert_close(flash_attention(q, k, v).float(),
                               attention_reference(q, k, v).float(),
                               **TOL[torch.bfloat16])


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = _randn((1, 32, 6, 128), torch.float32, cuda, 0)
    k = _randn((1, 32, 2, 128), torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="built for"):    # G = 3
        flash_attention(q, k, k)
    q64 = _randn((1, 32, 16, 64), torch.float32, cuda, 0)
    k64 = _randn((1, 32, 2, 64), torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="built for"):    # D = 64
        flash_attention(q64, k64, k64)
    q16 = _randn((1, 32, 16, 128), torch.float32, cuda, 0)
    with pytest.raises(TypeError):                        # mixed dtypes
        flash_attention(q16.bfloat16(), k, k)
    with pytest.raises(ValueError):                       # CPU + CUDA
        flash_attention(q16, k, k.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 16, 4096, (4, 37)])
def test_rmsnorm_kernel_matches_plain(cuda, rows, dtype):
    shape = (rows if isinstance(rows, tuple) else (rows,)) + (2048,)
    x = _randn(shape, dtype, cuda, 0) * 3
    r = _randn(shape, dtype, cuda, 1)
    w = _randn((2048,), dtype, cuda, 2) * 0.1
    before = K.LAUNCHES["fused_rmsnorm"]
    s, n = fused_rmsnorm(x, r, w, eps=1e-6)
    assert K.LAUNCHES["fused_rmsnorm"] == before + 1
    assert s.dtype == n.dtype == dtype and s.shape == n.shape == x.shape
    assert torch.equal(s, x + r)
    torch.testing.assert_close(n.float(),
                               rmsnorm_reference(x, r, w, 1e-6)[1].float(),
                               **TOL[dtype])


@pytest.mark.gpu
def test_rmsnorm_kernel_rejects_what_it_does_not_take(cuda):
    x = _randn((4, 2048), torch.bfloat16, cuda, 0)
    with pytest.raises(TypeError):                        # fp32 weight
        fused_rmsnorm(x, x, torch.zeros(2048, device=cuda))
    x3 = _randn((4, 2044), torch.bfloat16, cuda, 0)
    with pytest.raises(ValueError, match="16-byte"):      # D * 2 % 16 != 0
        fused_rmsnorm(x3, x3, x3[0])
