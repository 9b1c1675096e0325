#!/usr/bin/env python3
"""Ring attention and the sharded training step (dense and MoE) on one
card, against their dense, one-rank counterparts on the same card.

    python3 -m kubeai_tpu_torch.tools.sharded_check [--part ring|step|moe|all] [--small]

Run from the repository root. Thread ranks share the card and talk over
gloo, their collectives staged through host memory (parallel/group.py),
so the times are those of a test layout, not of a card per rank.

- ``ring``: causal attention at Llama-3.1-8B's widths (H 32, Kv 8, h 128,
  float32, B 1, S 8,192): the port's plain dense attention (forward and
  backward of a seeded output gradient, one KV head group at a time)
  once, then ring attention at
  sp = 2 and sp = 4 (parallel/ring_attention.py, one thread rank per
  block): output and q / k / v gradients against the dense ones within
  2·S·u of each tensor's max |value| (u = 2^-24: the worst-case float32
  error of a length-S sum, on either side); fwd + bwd wall, the ring
  passes' seconds, each rank's score bytes (S/sp)^2 against S^2, and the
  card's peak allocation.
- ``step``: train/trainer.py's step at Llama-3.1-8B's published widths
  (D 4,096, I 14,336, H 32, Kv 8, V 128,256), 2 of 32 layers, float32,
  lr 1e-4, global batch B 2 x S 2,048 of seeded tokens: one rank on the
  card (dense attention), then a dp = 2, sp = 2, tp = 2 mesh of eight
  thread ranks from the same weights (ring attention, fsdp + Megatron):
  the loss within 1e-4 relative, every leaf's gradient within 1e-3 of
  that leaf's max |g| (each rank compares its own block), the updated
  final_norm within rtol 1e-3 / atol 1e-5 (the JAX package's test); step
  wall, collective seconds by kind (summed over ranks), peak allocation.
- ``moe``: the same step for Mixtral-8x7B at its published widths (D
  4,096, I 14,336, E 8, k 2, H 32, Kv 8, V 32,000), 1 of 32 layers,
  float32, capacity factor 0.5 (so pairs drop, and which ones depends on
  the capacity being taken over the global tokens), B 2 x S 1,024, one
  rank against a dp = 2, ep = 2, tp = 2 mesh of eight thread ranks (the
  JAX package's test mesh): every layer's top-k expert ids and keep mask
  equal to one rank's exactly, the loss within 1e-6 relative, every
  leaf's gradient within 1e-5 of its max |g|, the updated final_norm;
  the pairs dropped, and how many pairs a capacity taken over each
  rank's own block would have kept differently.

``--small`` runs every part at narrow widths (a first check of a change, and
the card tests; ``--device cpu`` rehearses it without a card). Prints
one JSON line per part, prefixed with its name.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

T_START = time.perf_counter()  # the parts' lines give their end from here ("at_s")
U = 2.0**-24  # float32 unit roundoff
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3  # of each leaf's max |g|
NORM_TOL = dict(rtol=1e-3, atol=1e-5)

RING_FULL = dict(B=1, S=8192, H=32, Kv=8, h=128, sps=(2, 4))
RING_SMALL = dict(B=1, S=1024, H=8, Kv=2, h=64, sps=(2, 4))
STEP_MESH = dict(dp=2, sp=2, tp=2)
STEP_LAYERS = 2  # of Llama-3.1-8B's 32, at its published widths
MOE_MESH = dict(dp=2, ep=2, tp=2)
MOE_LAYERS = 1  # of Mixtral-8x7B's 32, at its published widths
MOE_FACTOR = 0.5
MOE_LOSS_RTOL = 1e-6
MOE_GRAD_TOL = 1e-5


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _peak_reset():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak() -> int | None:
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else None


def kernel_launches() -> dict:
    """The port's four kernel wrappers' launch counts (the training step
    runs none of them: its attention is plain or ring, its weights
    float32)."""
    from kubeai_tpu_torch.ops.flash_attention import flash_attention
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention
    from kubeai_tpu_torch.ops.quant import qdot

    return {fn.__name__: fn.launches for fn in (flash_attention, paged_attention_ragged,
                                                paged_decode_attention, qdot)}


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def ring_check(B, S, H, Kv, h, sps, seed=0, device="cuda") -> dict:
    """The ``ring`` part (see the module docstring)."""
    from kubeai_tpu_torch.ops.attention import attention, causal_mask
    from kubeai_tpu_torch.parallel.mesh import run_local_mesh
    from kubeai_tpu_torch.parallel.ring_attention import ring_attention, score_bytes

    t_all = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, S, H, h), generator=g, device=device)
    k = torch.randn((B, S, Kv, h), generator=g, device=device)
    v = torch.randn((B, S, Kv, h), generator=g, device=device)
    dout = torch.randn((B, S, H, h), generator=g, device=device)

    _peak_reset()
    # Dense attention one KV head (and its query group) at a time: the
    # heads are independent, and all of them at once would hold ~60 GB
    # of [S, S] scores for the backward.
    G = H // Kv
    mask = causal_mask(S, S, device=device)[None]
    want = {name: [] for name in ("out", "dq", "dk", "dv")}
    _sync()
    t0 = time.perf_counter()
    for j in range(Kv):
        qd = q[:, :, j * G:(j + 1) * G].clone().requires_grad_(True)
        kd, vd = (t[:, :, j:j + 1].clone().requires_grad_(True) for t in (k, v))
        o = attention(qd, kd, vd, mask)
        o.backward(dout[:, :, j * G:(j + 1) * G])
        for name, t in zip(want, (o.detach(), qd.grad, kd.grad, vd.grad)):
            want[name].append(t)
        del o, qd, kd, vd
    _sync()
    dense = {"fwd_bwd_s": time.perf_counter() - t0, "peak_bytes": _peak(),
             "head_groups": Kv}
    want = {name: torch.cat(parts, dim=2) for name, parts in want.items()}
    tol = 2 * S * U
    out = {"shape": dict(B=B, S=S, H=H, Kv=Kv, h=h), "dtype": "float32", "tol_rel": tol,
           "dense": dense, "sp": {}}
    for sp in sps:
        blk = S // sp
        _peak_reset()

        def rank(mesh):
            r = mesh.coords["sp"]
            part = slice(r * blk, (r + 1) * blk)
            qb, kb, vb = (t[:, part].clone().requires_grad_(True) for t in (q, k, v))
            _sync()
            t0 = time.perf_counter()
            o = ring_attention(qb, kb, vb, mesh.sp)
            o.backward(dout[:, part])
            _sync()
            wall = time.perf_counter() - t0
            calls, secs = mesh.sp.stats["ring_pass"]
            return {"wall": wall, "ring_calls": calls, "ring_s": secs, "out": o.detach(),
                    "dq": qb.grad, "dk": kb.grad, "dv": vb.grad}

        ranks = run_local_mesh({"sp": sp}, rank, device, timeout=600)
        errs = {name: _rel_err(torch.cat([r[name] for r in ranks], dim=1), want[name])
                for name in ("out", "dq", "dk", "dv")}
        bad = {n: e for n, e in errs.items() if not e <= tol}
        if bad:
            raise AssertionError(f"ring attention at sp = {sp} differs from dense attention "
                                 f"beyond {tol:.3g} of max |ref|: {bad}")
        sb = score_bytes(B, S, H, sp)
        out["sp"][str(sp)] = {
            "rel_err": errs, "fwd_bwd_wall_s": max(r["wall"] for r in ranks),
            "ring_passes": ranks[0]["ring_calls"],
            "ring_pass_s": [r["ring_s"] for r in ranks],
            "score_bytes_per_rank_step": sb["per_rank_step"], "score_bytes_dense": sb["dense"],
            "peak_bytes_all_ranks": _peak()}
        del ranks
    out["seconds"] = time.perf_counter() - t_all
    return out


def _batch(B, S, V, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
            "mask": (rng.random((B, S)) < 0.9).astype(np.int32)}


def routing_stats(routes, config, shape) -> dict:
    """Integers from the global (top-k ids, keep) [B, S, k] of each MoE
    layer: the pairs, those dropped, and those that a capacity taken over
    each (dp, sp) block's own tokens would have kept differently."""
    from kubeai_tpu_torch.models.llama import moe_capacity, moe_slots

    E, k, f = config.num_experts, config.num_experts_per_tok, config.moe_capacity_factor
    dp, sp = shape.get("dp", 1), shape.get("sp", 1)
    out = {"pairs": 0, "dropped": 0, "kept_differently_per_rank_capacity": 0}
    for ids, keep in routes:
        B, S = ids.shape[:2]
        Bl, Sl = B // dp, S // sp
        C = moe_capacity(Bl * Sl, E, k, f)
        out["pairs"] += keep.numel()
        out["dropped"] += int((~keep).sum())
        for i in range(dp):
            for j in range(sp):
                blk = (slice(i * Bl, (i + 1) * Bl), slice(j * Sl, (j + 1) * Sl))
                mine = moe_slots(ids[blk].reshape(-1), E) < C
                out["kept_differently_per_rank_capacity"] += int(
                    (mine != keep[blk].reshape(-1)).sum())
    return out


def step_check(config, B, S, shape=STEP_MESH, lr=1e-4, seed=0, device="cuda",
               loss_rtol=LOSS_RTOL, grad_tol=GRAD_TOL) -> dict:
    """The ``step`` part, and the ``moe`` part for a MoE *config* (see the
    module docstring)."""
    from kubeai_tpu_torch.parallel.group import to_host
    from kubeai_tpu_torch.parallel.mesh import run_local_mesh
    from kubeai_tpu_torch.parallel.sharding import key_paths, shard_mesh_group
    from kubeai_tpu_torch.train import trainer

    t_all = time.perf_counter()
    dev = torch.device(device)
    batch = _batch(B, S, config.vocab_size, seed + 1)
    launches0 = kernel_launches()

    _peak_reset()
    # Both runs draw from *seed* on the card (init_params draws the same
    # values whatever part of them a rank keeps).
    t0 = time.perf_counter()
    params, _, step = trainer.init_sharded_training(config, seed=seed, lr=lr, device=dev)
    n_params = sum(t.numel() for _, t in key_paths(params))
    _sync()
    t1 = time.perf_counter()
    want_loss = float(step({k: torch.from_numpy(v) for k, v in batch.items()}))
    _sync()
    t2 = time.perf_counter()
    ref = {"init_s": t1 - t0, "step_s": t2 - t1, "peak_bytes": _peak(), "loss": want_loss}
    want_routes = [tuple(t.cpu() for t in r) for r in step.routes or []]
    # Host copies of one rank's gradients and each leaf's max |g| (the
    # card is freed for the mesh run).
    want_grad = {p: to_host(t.grad) for p, t in key_paths(params)}
    want_scale = {p: float(t.grad.abs().max()) or 1.0 for p, t in key_paths(params)}
    want_norm = params["final_norm"].detach().cpu()
    ref["host_copy_s"] = time.perf_counter() - t2
    del params, step
    _peak_reset()

    def rank(mesh):
        t0 = time.perf_counter()
        # Ranks draw at once: each holds one whole group at a time (at
        # most the 2.1 GB embedding), beside blocks of ~1 GB.
        p, opt, st = trainer.init_sharded_training(config, mesh, seed=seed, lr=lr)
        _sync()
        init_s = time.perf_counter() - t0
        for g in mesh.all_groups():
            g.stats = {kind: [0, 0.0] for kind in g.stats}
        t0 = time.perf_counter()
        loss = float(st(batch))
        _sync()
        wall = time.perf_counter() - t0
        peak = _peak()
        opt.state.clear()  # Adam's moments: room on the card for the comparison
        t0 = time.perf_counter()
        errs = {}
        for path, leaf in key_paths(p):
            # Cut on the card: the host's strided copies of a whole leaf
            # per rank take several times as long.
            mine = shard_mesh_group(path, want_grad[path].to(leaf.device), config, mesh)
            errs["/".join(path)] = float((leaf.grad - mine).abs().max()) / want_scale[path]
            del mine
        compare_s = time.perf_counter() - t0
        coll: dict = {}
        for g in mesh.all_groups():
            for kind, (calls, secs) in g.stats.items():
                c = coll.setdefault(f"{g.axis}.{kind}", [0, 0.0])
                c[0] += calls
                c[1] += secs
        routes_equal = [bool(torch.equal(a.cpu(), b) and torch.equal(m.cpu(), n))
                        for (a, m), (b, n) in zip(st.routes or [], want_routes)]
        return {"loss": loss, "wall": wall, "errs": errs, "coll": coll, "phases": st.phases,
                "peak": peak, "routes_equal": routes_equal, "init_s": init_s,
                "compare_s": compare_s,
                "final_norm": p["final_norm"].detach().cpu(),
                "shard_numel": sum(t.numel() for _, t in key_paths(p))}

    t0 = time.perf_counter()
    ranks = run_local_mesh(shape, rank, device, timeout=900)
    mesh_s = time.perf_counter() - t0
    losses = [r["loss"] for r in ranks]
    errs = {k: max(r["errs"][k] for r in ranks) for k in ranks[0]["errs"]}
    coll: dict = {}
    for r in ranks:
        for k, (c, s) in r["coll"].items():
            e = coll.setdefault(k, [0, 0.0])
            e[0] += c
            e[1] += s
    problems = []
    routes_equal = [all(r["routes_equal"]) and len(r["routes_equal"]) == len(want_routes)
                    for r in ranks]
    if not all(routes_equal):
        problems.append(f"top-k ids or keep masks differ from one rank's on ranks "
                        f"{[i for i, ok in enumerate(routes_equal) if not ok]}")
    if max(abs(x - want_loss) for x in losses) > loss_rtol * abs(want_loss):
        problems.append(f"loss {losses} against one rank's {want_loss}")
    bad = {k: e for k, e in errs.items() if not e <= grad_tol}
    if bad:
        problems.append(f"gradients beyond {grad_tol} of max |g|: {bad}")
    for r in ranks:
        if not torch.allclose(r["final_norm"], want_norm, **NORM_TOL):
            problems.append("the updated final_norm differs from one rank's")
            break
    if problems:
        raise AssertionError("sharded step: " + "; ".join(problems))
    cfg = {"hidden": config.hidden_size, "intermediate": config.intermediate_size,
           "heads": config.num_heads, "kv_heads": config.num_kv_heads,
           "vocab": config.vocab_size, "layers": config.num_layers, "dtype": "float32"}
    moe = {}
    if want_routes:
        cfg.update(experts=config.num_experts, experts_per_tok=config.num_experts_per_tok,
                   capacity_factor=config.moe_capacity_factor)
        moe = {"routes_equal": True, "routing": routing_stats(want_routes, config, shape)}
    return {
        "config": cfg, **moe, "tolerances": {"loss_rtol": loss_rtol, "grad_tol": grad_tol},
        "params": n_params, "batch": [B, S], "mesh": shape, "lr": lr,
        "one_rank": ref, "loss": losses[0], "loss_rel_err": abs(losses[0] - want_loss) /
        abs(want_loss), "grad_rel_err_max": max(errs.values()),
        "grad_rel_err": errs,
        "step_wall_s": max(r["wall"] for r in ranks), "mesh_run_s": mesh_s,
        "mesh_init_s_max": max(r["init_s"] for r in ranks),
        "compare_s_max": max(r["compare_s"] for r in ranks),
        "phases_s_max_over_ranks": {k: max(r["phases"][k] for r in ranks)
                                    for k in ranks[0]["phases"]},
        "peak_bytes_after_step": max(r["peak"] or 0 for r in ranks),
        "collective_s_by_kind": {k: round(s, 4) for k, (c, s) in sorted(coll.items()) if c},
        "collective_calls_by_kind": {k: c for k, (c, s) in sorted(coll.items()) if c},
        "shard_numel_per_rank": ranks[0]["shard_numel"],
        "peak_bytes_all_ranks": _peak(),
        "kernel_launches": {k: n - launches0[k] for k, n in kernel_launches().items()},
        "seconds": time.perf_counter() - t_all}


def small_config():
    from kubeai_tpu_torch.models.base import llama_3_1_8b, mixtral_8x7b

    return llama_3_1_8b(num_layers=2, hidden_size=256, intermediate_size=512, num_heads=8,
                        num_kv_heads=2, head_dim=32, vocab_size=1024).replace(dtype="float32")


def small_moe_config():
    from kubeai_tpu_torch.models.base import mixtral_8x7b

    return mixtral_8x7b(num_layers=2, hidden_size=256, intermediate_size=512, num_heads=8,
                        num_kv_heads=2, head_dim=32, vocab_size=1024,
                        moe_capacity_factor=MOE_FACTOR).replace(dtype="float32")


def moe_check(config, B, S, device="cuda") -> dict:
    """The ``moe`` part (see the module docstring)."""
    return step_check(config, B, S, shape=MOE_MESH, device=device, loss_rtol=MOE_LOSS_RTOL,
                      grad_tol=MOE_GRAD_TOL)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("ring", "step", "moe", "all"), default="all")
    ap.add_argument("--small", action="store_true", help="narrow widths (a quick check)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from kubeai_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kubeai_tpu_torch.models.base import llama_3_1_8b, mixtral_8x7b

    def emit(name, out):
        out["at_s"] = time.perf_counter() - T_START
        print(f"sharded_train[{name}]", json.dumps(out), flush=True)

    if args.part in ("ring", "all"):
        cfg = RING_SMALL if args.small else RING_FULL
        emit("ring", ring_check(**cfg, device=dev))
        _peak_reset()
    if args.part in ("step", "all"):
        if args.small:
            config, B, S = small_config(), 2, 256
        else:
            config = llama_3_1_8b(num_layers=STEP_LAYERS).replace(dtype="float32")
            B, S = 2, 2048
        emit("step", step_check(config, B, S, device=dev))
        _peak_reset()
    if args.part in ("moe", "all"):
        if args.small:
            config, B, S = small_moe_config(), 2, 256
        else:
            config = mixtral_8x7b(num_layers=MOE_LAYERS, moe_capacity_factor=MOE_FACTOR
                                  ).replace(dtype="float32")
            B, S = 2, 1024
        emit("moe", moe_check(config, B, S, device=dev))
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # Without the interpreter's teardown: freeing the tens of GB of pinned
    # host blocks that the staged collectives cached takes ~6 s on the
    # card's machine, inside chip_smoke's phase budget.
    os._exit(code)
