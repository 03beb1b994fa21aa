"""The statistics that make a sharded training step compute the unsharded
function, one operand at a time, on the CPU (no process group: the
shards' statistics are all-reduced here by hand, as ``AxisComm.amax``
does).

Each case splits an operand as a mesh axis would, quantizes every shard
against the all-reduced statistics and adds the shards' results in rank
order; each is held against the unsharded function to ``TOL`` of its
largest output (fp32 sums in another order; read at most 4.9e-7):

* B1's given row range (uint8 rows: the all-reduced minima and maxima):
  the plain version against the rows' own range, bit-equal;
* a row-parallel quantized matmul: uint8 input rows and an int8 weight in
  groups re-quantized for the matmul (both against their whole rows);
* a column-parallel uint8 grad-input (W's columns by their all-reduced
  ranges, g's rows by their absolute maxima);
* a data-sharded grad-weight, int8 and uint8 (the columns over every
  rank's tokens), and a saved quantized input (``_save_columnwise``).
"""

import pytest
import torch

import sdnq_tpu_torch as T
from sdnq_tpu_torch.kernels import scaled_mm as ks
from sdnq_tpu_torch.layers import _quantized_matmul_2d
from sdnq_tpu_torch.parallel.sharding import _take_qt, qtensor_shardings
from sdnq_tpu_torch.train import matmul as tm

TOL = 1e-6


class _Mesh:
    """The shape a ``qtensor_shardings`` call reads."""

    def __init__(self, n):
        self.shape = {"tensor": n, "data": 1, "fsdp": 1}


def _allreduce(parts):
    """``AxisComm.amax`` over the shards' values, by hand."""
    return torch.stack(parts).amax(0)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_given_row_range_equals_own():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(37, 200, generator=g).bfloat16()
    own = ks.quantize_rows_plain(x, "uint8", k_pad=5)
    given = ks.quantize_rows_plain(
        x, "uint8", k_pad=5, row_range=(x.float().amin(-1),
                                        x.float().amax(-1)))
    for a, b in zip(own, given):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="uint8"):
        ks.quantize_rows_plain(x, "int8", row_range=(x.amin(-1),
                                                     x.amax(-1)))


@pytest.mark.parametrize("fmt,group", [("uint8", -1), ("int8", 32),
                                       ("uint8", 32)])
def test_row_parallel_quantized_matmul(fmt, group):
    """Two shards of the input columns: the rows' statistics of x and
    of the re-quantized weight all-reduced, the fp32 partial outputs
    added."""
    g = torch.Generator().manual_seed(1)
    w = torch.randn(48, 128, generator=g) * 0.05
    x = torch.randn(40, 128, generator=g) + 0.3
    qt = T.quantize_tensor(w, fmt, group_size=group,
                           use_quantized_matmul=True)
    want = _quantized_matmul_2d(x, qt, None, torch.float32)
    pls = qtensor_shardings(qt, _Mesh(2), "row")
    shards = [_take_qt(qt, pls, r, False) for r in range(2)]
    xs = [x[:, :64], x[:, 64:]]
    # each rank's values at each of its calls, then every call's
    # all-reduce over the ranks
    seen = [[], []]
    for r in range(2):
        _quantized_matmul_2d(xs[r], shards[r], None, torch.float32,
                             x_amax_reduce=lambda v, r=r: seen[r].append(v)
                             or v)
    assert len(seen[0]) == (2 if group > 0 else 1)
    got = []
    for r in range(2):
        calls = iter(zip(*seen))
        got.append(_quantized_matmul_2d(
            xs[r], shards[r], None, torch.float32,
            x_amax_reduce=lambda v: _allreduce(list(next(calls)))))
    assert _rel(got[0] + got[1], want) <= TOL


def test_column_parallel_uint8_grad_input():
    g = torch.Generator().manual_seed(2)
    w = torch.randn(256, 128, generator=g)
    gy = torch.randn(64, 256, generator=g)
    qt = T.quantize_tensor(w, "uint8", group_size=32,
                           use_quantized_matmul=True)
    want = tm._grad_input(gy, qt, torch.float32)
    pls = qtensor_shardings(qt, _Mesh(2), "col")
    shards = [_take_qt(qt, pls, r, False) for r in range(2)]
    gs = [gy[:, :128], gy[:, 128:]]
    per = [tm.grad_input_stats(a, s) for a, s in zip(gs, shards)]
    assert len(per[0]) == 3   # g's row amax, -W's column min, its max
    st = tuple(_allreduce(list(v)) for v in zip(*per))
    got = sum(tm._grad_input(a, s, torch.float32, st)
              for a, s in zip(gs, shards))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("fmt", ["int8", "uint8", "float8_e4m3fn"])
def test_data_sharded_grad_weight(fmt):
    g = torch.Generator().manual_seed(3)
    gy = torch.randn(256, 64, generator=g)
    x = torch.randn(256, 96, generator=g) + 0.3
    want = ks.dynamic_mm_tn(gy, x, fmt)
    unsigned = fmt == "uint8"
    rows = [slice(i, i + 64) for i in range(0, 256, 64)]

    def reduced(t):
        per = [tm.token_stats(t[r], unsigned) for r in rows]
        if unsigned:
            lo = -_allreduce([-p[0] for p in per])
            return lo, _allreduce([p[1] for p in per])
        return _allreduce(per)
    st = (reduced(gy), reduced(x))
    assert st[0] is not None
    got = sum(ks.dynamic_mm_tn(gy[r], x[r], fmt, stats=st) for r in rows)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("fmt", ["int8", "uint8"])
def test_saved_columnwise_under_data_axis(fmt):
    """The saved input's codes under a data axis (its columns' statistics
    over every rank's tokens) are the unsharded codes' rows."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(128, 96, generator=g).bfloat16()
    qt = T.quantize_tensor(torch.randn(64, 96, generator=g), fmt)
    whole = tm._save_columnwise(x, qt)

    class Comm:   # the data axis's all-reduce over four shards of x
        def amax(self, v):
            parts = [tm.token_stats(x[i:i + 32].float(), fmt == "uint8")
                     for i in range(0, 128, 32)]
            if fmt == "uint8":
                lo = torch.stack([p[0] for p in parts]).amin(0)
                hi = torch.stack([p[1] for p in parts]).amax(0)
                return torch.stack([-lo, hi])
            return torch.stack(parts).amax(0)
    for i in range(0, 128, 32):
        part = tm._save_columnwise(x[i:i + 32], qt, Comm())
        assert torch.equal(part[0], whole[0][i:i + 32])
        for a, b in zip(part[1:], whole[1:]):
            assert torch.equal(a, b)
