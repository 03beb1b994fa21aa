"""Host-side logic of B10 (``scaled_mm_tn``) and B6 (``blockdiag_mm``) on
the card, checked here on the CPU: B6's minifloat table against the JAX
package's ``decode_float`` for every minifloat format of 1 to 7 bits, B10's
stage plan (tokens a stage, walk order), and which operands
each wrapper copies for alignment (and which it passes through as they
are)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdnq_tpu import packing as jpk
from sdnq_tpu.formats import get_format as jget_format
from sdnq_tpu_torch.formats import FORMATS, get_format
from sdnq_tpu_torch.kernels import _build
from sdnq_tpu_torch.kernels import dequant_mm as kd
from sdnq_tpu_torch.kernels import scaled_mm as ks

MINIFLOATS = sorted(n for n, f in FORMATS.items()
                    if not f.is_integer and f.num_bits <= 7)


def test_every_minifloat_width_is_covered():
    assert {get_format(n).num_bits for n in MINIFLOATS} == set(range(1, 8))


@pytest.mark.parametrize("name", MINIFLOATS)
def test_minifloat_table_equals_jax_decode_float(name):
    """B6 decodes minifloat codes through a table of their 2^bits values,
    made on the host: every entry, sign of zero included, equals the JAX
    package's ``decode_float`` of that code."""
    f = get_format(name)
    table = kd.minifloat_table(f, "cpu")
    assert table.dtype == torch.float32 and table.shape == (1 << f.num_bits,)
    codes = jnp.arange(1 << f.num_bits, dtype=jnp.int32)
    ref = np.asarray(jpk.decode_float(codes, jget_format(name)),
                     dtype=np.float32)
    np.testing.assert_array_equal(table.numpy().view(np.int32),
                                  ref.view(np.int32))
    assert kd.minifloat_table(f, "cpu") is table   # made once


@pytest.mark.parametrize("m,n,k,dtype,want", [
    # FLUX.1-dev training: linear1 and img fc1 grad-weights, 128-token
    # stages, A (M, N) the larger operand: K tiles fastest
    (1536, 21504, 3072, torch.int8, (128, True)),
    (1024, 12288, 3072, torch.int8, (128, True)),
    # a modulation linear at batch 1: one 32-token stage
    (1, 18432, 3072, torch.int8, (32, True)),
    # e4m3: 64-token stages (its fp16 stages are twice the bytes)
    (1536, 21504, 3072, torch.float8_e4m3fn, (64, True)),
    (70, 200, 136, torch.float8_e4m3fn, (64, True)),
    # linear2's grad-weight: B (M, K) the larger operand, N tiles fastest
    (1536, 3072, 15360, torch.int8, (128, False)),
    # ragged M below a full stage rounds up to 32, 64 or 96 tokens (96 is
    # no power of two: the kernel takes any multiple of 32)
    (1, 8, 64, torch.int8, (32, False)),
    (33, 260, 516, torch.int8, (64, False)),
    (65, 200, 136, torch.int8, (96, True)),
    (70, 200, 136, torch.int8, (96, True)),
    (96, 132, 260, torch.int8, (96, False)),
    (97, 132, 260, torch.int8, (128, False)),
    (1536, 384, 640, torch.int8, (128, False)),
])
def test_tn_plan(m, n, k, dtype, want):
    tok, k_fast = ks.tn_plan(m, n, k, dtype)
    assert (tok, k_fast) == want
    # what the C entry takes: a multiple of 32 up to the kind's full stage
    assert tok % 32 == 0 and 32 <= tok <= (128 if dtype == torch.int8
                                           else 64)


def test_tn_operands_copy_only_what_tma_cannot_read():
    """B10's operands go through ``_build.tma_rows``: a tensor whose rows
    TMA can read in place passes through; rows that are not a multiple of
    16 bytes apart (N or K a multiple of 4 but not of 16) or a view off a
    16-byte boundary are copied into rows of a multiple of 16 bytes, zeros
    past N or K; e4m3 codes alike."""
    a = torch.randint(-128, 128, (40, 64), dtype=torch.int8)
    assert _build.tma_rows(a) is a
    a = torch.randint(-128, 128, (40, 100), dtype=torch.int8)   # 100 % 16
    ca = _build.tma_rows(a)
    assert ca.stride(0) == 112 and torch.equal(ca[:, :100], a)
    assert not ca[:, 100:].any()
    flat = torch.randint(-128, 128, (1 + 40 * 48,), dtype=torch.int8)
    view = flat[1:].view(40, 48)
    assert view.data_ptr() % 16
    cb = _build.tma_rows(view)
    assert cb.data_ptr() % 16 == 0 and torch.equal(cb, view)
    e4 = torch.randn(8, 32).to(torch.float8_e4m3fn)
    ca = _build.tma_rows(e4[:, :20])
    assert ca.stride(0) == 32 and ca.dtype == torch.float8_e4m3fn
    assert torch.equal(ca[:, :20].view(torch.uint8),
                       e4[:, :20].view(torch.uint8))


def test_tn_lowrank_operands():
    """The rank-R term goes to the kernel as fp32 contiguous u (N, R) and
    v (R, K); tensors that already are so pass through."""
    u, v = torch.randn(6, 2), torch.randn(2, 5)
    cu, cv, r = ks._tn_lowrank(u, v, 6, 5)
    assert cu is u and cv is v and r == 2
    cu, cv, r = ks._tn_lowrank(u.double(), v.t().contiguous().t(), 6, 5)
    assert cu.dtype == torch.float32 and cv.is_contiguous() and r == 2
    assert ks._tn_lowrank(None, None, 6, 5) == (None, None, 0)
    with pytest.raises(ValueError):
        ks._tn_lowrank(u, torch.randn(3, 5), 6, 5)


def test_blockdiag_operands_copy_only_what_the_kernel_cannot_read():
    """B6's operands: fp32 or bf16 x, contiguous, on a 16-byte boundary;
    codes contiguous on an 8-byte boundary; fp32 contiguous scale, zpc and
    bias (O,).  What already is so passes through; fp16 x becomes fp32, a
    view off its boundary or with strides is copied, a (1, O) bias is
    viewed as (O,)."""
    x = torch.randn(3, 64)
    codes = torch.zeros(5, 32, dtype=torch.uint8)
    scale, zpc, bias = torch.rand(5, 2), torch.rand(5, 2), torch.randn(5)
    got = kd.blockdiag_operands(x, codes, scale, zpc, bias)
    assert all(g is w for g, w in zip(got, (x, codes, scale, zpc, bias)))
    xb = x.bfloat16()
    assert kd.blockdiag_operands(xb, codes, scale, zpc, None)[0] is xb
    got = kd.blockdiag_operands(x.half(), codes, scale.double(), zpc, None)
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.float32
    flat = torch.randn(1 + 3 * 64)
    xv = flat[1:].view(3, 64)
    assert xv.data_ptr() % 16
    cx = kd.blockdiag_operands(xv, codes, scale, zpc, None)[0]
    assert cx.data_ptr() % 16 == 0 and torch.equal(cx, xv)
    cx = kd.blockdiag_operands(torch.randn(64, 3).t(), codes, scale, zpc,
                               None)[0]
    assert cx.is_contiguous()
    flat = torch.zeros(4 + 5 * 32, dtype=torch.uint8)
    cv = flat[4:].view(5, 32)
    cc = kd.blockdiag_operands(x, cv, scale, zpc, None)[1]
    assert cc.data_ptr() % 8 == 0 and torch.equal(cc, cv)
    b2 = bias.reshape(1, 5)
    cb = kd.blockdiag_operands(x, codes, scale, zpc, b2)[4]
    assert cb.shape == (5,) and cb.data_ptr() == b2.data_ptr()
