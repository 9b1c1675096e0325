"""The ``threads`` backend (parallel/group.py ThreadGroup): thread ranks
of one process exchange host tensors in memory. Its collectives give
what gloo's give on the same inputs, the mesh trainer's step over it
matches one rank as it does over gloo, and a rank that never arrives
makes the others raise instead of hanging."""

from __future__ import annotations

import pytest
import torch

from kubeai_tpu_torch.parallel.group import make_process_group, run_local_ranks, run_threads


def _collectives(g):
    gen = torch.Generator().manual_seed(g.rank)
    x = torch.randn(1001, generator=gen)
    y = torch.randn(4 * g.world_size, 3, generator=gen)
    return (g.all_reduce(x.clone()),
            g.reduce_scatter_dim(y.clone(), 0),
            g.all_gather_dim(torch.randn(3, 5, generator=gen) + g.rank, 1),
            g.ring_shift(torch.full((2, 3), float(g.rank))),
            g.ring_shift(torch.full((2,), float(g.rank)), step=-1),
            (x, y))


def _in_rank_order(ts):
    out = ts[0].clone()
    for t in ts[1:]:
        out += t
    return out


@pytest.mark.parametrize("W", [2, 3, 4])
def test_collectives_equal_gloos(W):
    gloo = run_local_ranks(W, _collectives, "cpu", backend="gloo")
    threads = run_local_ranks(W, _collectives, "cpu", backend="threads")
    x_sum = _in_rank_order([r[5][0] for r in threads])
    y_sum = _in_rank_order([r[5][1] for r in threads])
    for r, (a, b) in enumerate(zip(gloo, threads)):
        # Sums run in rank order (gloo's order may differ in the last bit).
        assert torch.equal(b[0], x_sum)
        assert torch.equal(b[1], y_sum[4 * r:4 * (r + 1)])
        for i in (0, 1):
            torch.testing.assert_close(b[i], a[i], rtol=0, atol=1e-6)
        for i in (2, 3, 4):
            assert torch.equal(a[i], b[i]), (r, i)


def test_a_missing_rank_raises():
    from torch import distributed as dist

    store = dist.HashStore()
    pgs = [make_process_group(store, r, 2, "threads", timeout=0.5, prefix="t") for r in (0, 1)]
    with pytest.raises(RuntimeError, match="did not arrive"):
        pgs[0].allreduce([torch.ones(3)])
    # A receive with no send.
    with pytest.raises(RuntimeError, match="no send"):
        pgs[1].recv([torch.empty(2)], 0).wait()


def test_groups_under_one_store_stay_apart():
    """Two groups of the same ranks under one store, each under its own
    prefix, interleaved: each rank's sums stay in their own group."""
    from torch import distributed as dist

    store = dist.HashStore()

    def rank_fn(rank, dev):
        a = make_process_group(store, rank, 2, "threads", timeout=30, prefix="a")
        b = make_process_group(store, rank, 2, "threads", timeout=30, prefix="b")
        x, y = torch.full((4,), rank + 1.0), torch.full((4,), 10.0 * (rank + 1))
        a.allreduce([x]).wait()
        b.allreduce([y]).wait()
        return x, y

    for x, y in run_threads(2, rank_fn, "cpu", timeout=60):
        assert torch.equal(x, torch.full((4,), 3.0)) and torch.equal(y, torch.full((4,), 30.0))


@pytest.mark.parametrize("part", ["step", "moe"])
def test_sharded_step_over_threads_matches_gloo(part):
    """tools/sharded_check.py's step and moe parts at narrow widths on the
    CPU: over either backend within the check's tolerances of one rank,
    and the same loss and final_norm over both."""
    from kubeai_tpu_torch.tools import sharded_check as sc

    if part == "step":
        config, run = sc.small_config(), sc.step_check
    else:
        config, run = sc.small_moe_config(), sc.moe_check
    out = {b: run(config, 2, 64, device="cpu", backend=b) for b in ("gloo", "threads")}
    tol = sc.GRAD_TOL if part == "step" else sc.MOE_GRAD_TOL
    for b, res in out.items():
        assert res["backend"] == b
        assert res["grad_rel_err_max"] <= tol, (b, res["grad_rel_err_max"])
    assert out["threads"]["loss"] == pytest.approx(out["gloo"]["loss"], rel=1e-6)
    if part == "moe":
        assert out["threads"]["routes_equal"] and out["gloo"]["routes_equal"]
