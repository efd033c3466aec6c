"""The port's roofline cost model (``repro_torch.launch.roofline``) on
hand-built FX graphs, as ``tests/test_roofline.py`` holds the
reference's on hand-written HLO: matmul flops, skipped views, the
gather and scatter rule, all-reduce's factor 2, the NVLink or
InfiniBand choice by a collective's group, the terms, ``bottleneck``
and ``mfu_bound``, and the liveness walk's peak."""

import pytest

pytest.importorskip("torch")
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch.mesh import fake_mesh  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16


def _graph(fn, *args):
    return make_fx(fn, tracing_mode="fake")(*args)


def test_mm_and_bmm_flops():
    a, b = torch.randn(8, 16), torch.randn(16, 32)
    cost = rf.analyze_graph(_graph(lambda a, b: a @ b, a, b))
    assert cost.flops_f32 == 2 * 8 * 16 * 32 and cost.flops == 0
    x, y = torch.randn(3, 4, 5, dtype=BF16), torch.randn(3, 5, 6, dtype=BF16)
    cost = rf.analyze_graph(_graph(torch.bmm, x, y))
    assert cost.flops == 2 * 3 * 4 * 5 * 6 and cost.flops_f32 == 0
    c = torch.randn(8, 32)
    cost = rf.analyze_graph(_graph(torch.addmm, c, a, b))
    assert cost.flops_f32 == 2 * 8 * 16 * 32


def test_float32_product_of_bf16_upcasts_is_charged_at_bf16():
    """The plain versions upcast bf16 operands that the kernels feed to
    the tensor cores: such a product counts at the bf16 rate."""
    q, k = torch.randn(4, 8, dtype=BF16), torch.randn(8, 4, dtype=BF16)
    cost = rf.analyze_graph(_graph(lambda q, k: q.float() @ k.float(), q, k))
    assert cost.flops == 2 * 4 * 8 * 4 and cost.flops_f32 == 0
    p, v = torch.randn(4, 8), torch.randn(8, 4, dtype=BF16)
    cost = rf.analyze_graph(_graph(lambda p, v: p @ v.float(), p, v))
    assert cost.flops == 2 * 4 * 8 * 4


def test_views_move_no_bytes():
    x = torch.randn(4, 8)
    cost = rf.analyze_graph(_graph(
        lambda x: x.view(8, 4).unsqueeze(0).squeeze(0).t()[1:], x))
    assert cost.bytes == 0
    # reshaping a transposed tensor copies it: charged
    cost = rf.analyze_graph(_graph(lambda x: x.t().reshape(32), x))
    assert cost.bytes == 2 * 4 * 32
    cost = rf.analyze_graph(_graph(lambda x: x.view(8, 4).t() * 2, x))
    assert cost.bytes == 2 * 4 * 32          # mul: result + operand


def test_gather_and_scatter_charge_the_data_moved():
    """A gather is charged twice its result, a scatter twice its update,
    never the whole buffer (the reference's dynamic-slice and DUS
    rule)."""
    table = torch.randn(1000, 16)
    idx = torch.tensor([3, 7, 9])
    cost = rf.analyze_graph(_graph(lambda t, i: t[i], table, idx))
    assert cost.bytes == 2 * 3 * 16 * 4
    upd = torch.randn(3, 16)
    cost = rf.analyze_graph(_graph(
        lambda t, i, u: t.index_put((i,), u), table, idx, upd))
    assert cost.bytes == 2 * 3 * 16 * 4


def test_collectives_factor_link_and_largest():
    """all_reduce moves twice its bytes; a group within one node of 8
    ranks goes at NVLink's rate, one across nodes at InfiniBand's."""
    with fake_mesh((2, 8), ("data", "model")) as mesh:
        model = mesh.get_group("model").group_name     # ranks 0..7
        data = mesh.get_group("data").group_name       # ranks 0, 8

        def fn(x, y):
            a = torch.ops._c10d_functional.all_reduce(x, "sum", model)
            a = torch.ops._c10d_functional.wait_tensor(a)
            g = torch.ops._c10d_functional.all_gather_into_tensor(
                y, 2, data)
            g = torch.ops._c10d_functional.wait_tensor(g)
            return a, g

        x, y = torch.randn(64, 32), torch.randn(16, 8, dtype=BF16)
        cost = rf.analyze_graph(_graph(fn, x, y))
    ar, ag = 64 * 32 * 4, 32 * 8 * 2
    assert cost.coll_bytes_nvlink == 2 * ar
    assert cost.coll_bytes_ib == ag
    assert cost.coll_bytes_weighted == 2 * ar + ag
    assert cost.coll_counts == {"all_reduce": 1, "all_gather_into_tensor": 1}
    assert cost.largest_collective[0].startswith("all_reduce float32[64, 32]")
    assert "NVLink" in cost.largest_collective[0]
    assert cost.bytes == 2 * (ar + ag)
    assert not dist.is_initialized()


def test_roofline_terms_bottleneck_and_mfu_bound():
    r = rf.Roofline(chips=4, flops=989e12, hbm_bytes=3.35e12 * 2,
                    coll_bytes=0.0, model_flops=2 * 989e12,
                    flops_f32=67e12, coll_bytes_nvlink=450e9,
                    coll_bytes_ib=50e9 * 3)
    assert r.t_compute == pytest.approx(2.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(4.0)
    assert r.bottleneck == "collective"
    assert r.mfu_bound == pytest.approx(2 * 989e12 / (4 * 989e12 * 4.0))
    assert r.useful_fraction == pytest.approx(2 * 989e12 / (4 * (989e12
                                                               + 67e12)))
    d = r.as_dict()
    for key in ("chips", "hlo_flops_per_device", "hbm_bytes_per_device",
                "collective_bytes_per_device", "t_compute_s", "t_memory_s",
                "t_collective_s", "bottleneck", "model_flops",
                "useful_flop_fraction", "mfu_bound", "coll_counts",
                "largest_collective"):
        assert key in d
    assert rf.Roofline(chips=1, flops=0, hbm_bytes=0,
                       coll_bytes=0).mfu_bound == 0.0


def test_peak_temp_bytes_follows_liveness():
    """Each result lives from its node to its last use, a view keeps its
    base live, an output lives to the end; arguments are not counted."""
    def fn(x):
        a = x * 2               # 256 B, read by b and by the output view
        b = a + 1               # 256 B, dies at c
        c = b.sum()             # 4 B
        return a.view(8, 8), c
    x = torch.randn(64)
    gm = _graph(fn, x)
    assert rf.peak_temp_bytes(gm) == 256 + 256 + 4
