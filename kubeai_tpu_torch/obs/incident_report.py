"""Renders one incident document as a time-ordered timeline (port of
kubeai_tpu/obs/incident_report.py): autoscaler decisions, breaker flips,
stall attribution, SLO state, canary probes, tenants, the history
sparklines before the trigger, the forecast against what arrived, log
records and the requests around it.

    python -m kubeai_tpu_torch.obs.incident_report              # the latest on disk
    python -m kubeai_tpu_torch.obs.incident_report --id ID      # one incident
    python -m kubeai_tpu_torch.obs.incident_report --list       # the index
    python -m kubeai_tpu_torch.obs.incident_report --url http://operator:8000

It reads the disk ring (``--dir``, else ``KUBEAI_INCIDENT_DIR``), so it
works after the operator is gone, or a live operator's
``/debug/incidents`` (``--url``). The rendering is the JAX renderer's,
byte for byte, and either package's ring reads in either.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from kubeai_tpu_torch.obs.incidents import incident_dir_default


def _fmt_t(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(t)) + f".{int(t * 1000) % 1000:03d}"


def _entry(t: float | None, source: str, text: str) -> tuple[float | None, str, str]:
    return (t, source, text)


def _autoscaler_entries(section: dict) -> list:
    out = []
    for r in section.get("decisions", []) or []:
        t = r.get("t")
        pool = f" pool={r['pool']}" if r.get("pool") else ""
        sig = r.get("signal")
        if isinstance(sig, dict):
            sig_s = " ".join(
                f"{k}={v}" for k, v in sig.items() if not isinstance(v, dict)
            )
        else:
            sig_s = f"signal={sig}"
        out.append(_entry(
            t, "autoscaler",
            f"{r.get('model', '?')}{pool}: desired={r.get('desired')} "
            f"current={r.get('current')} applied={r.get('applied')} "
            f"reason={r.get('reason')} ({sig_s})",
        ))
    return out


def _breaker_entries(section: dict, captured_at: float) -> list:
    out = []
    for model, eps in (section.get("models") or {}).items():
        for ep in eps:
            state = ep.get("state")
            if state and state != "closed":
                age = ep.get("opened_age_s")
                t = captured_at - age if isinstance(age, (int, float)) else captured_at
                out.append(_entry(
                    t, "breaker",
                    f"{model}/{ep.get('address')} -> {state.upper()} "
                    f"(consecutive_failures={ep.get('consecutive_failures')}, "
                    f"role={ep.get('role') or 'unified'})",
                ))
    return out


def _trace_entries(section: dict, limit: int = 12) -> list:
    out = []
    timelines = (section.get("requests") or [])[:limit]
    for tl in timelines:
        t = tl.get("start_ms", 0) / 1000.0
        phases = ", ".join(
            f"{p['name']}={p['duration_ms']:.0f}ms" for p in tl.get("phases", [])
        )
        rid = tl.get("request_id", "?")
        tag = " [canary]" if str(rid).startswith("canary-") else ""
        out.append(_entry(
            t, "request",
            f"{rid}{tag} ({tl.get('component')}) model={tl.get('model')} "
            f"outcome={tl.get('outcome')} dur={tl.get('duration_ms', 0):.0f}ms "
            f"{phases}",
        ))
    return out


def _canary_entries(section: dict) -> list:
    out = []
    for model, rec in (section.get("models") or {}).items():
        line = f"{model}: outcome={rec.get('outcome')}"
        if rec.get("outcome") == "corrupt":
            line += (
                f" fingerprint={rec.get('fingerprint')} !="
                f" baseline={rec.get('baseline')} text={rec.get('text')!r}"
            )
        elif rec.get("outcome") == "error":
            line += f" error={rec.get('error')}"
        elif rec.get("e2e_s") is not None:
            line += f" e2e={rec['e2e_s']}s ttft={rec.get('ttft_s')}s"
        out.append(_entry(rec.get("t"), "canary", line))
    return out


def _slo_entries(section: dict, captured_at: float) -> list:
    out = []
    for o in section.get("objectives", []) or []:
        if o.get("pending"):
            continue
        out.append(_entry(
            captured_at, "slo",
            f"{o.get('name')}: attainment={o.get('attainment')} "
            f"burn_rate={o.get('burn_rate')} over {o.get('requests')} reqs "
            f"(target {o.get('target')})",
        ))
    return out


def _engine_entries(section: dict, captured_at: float) -> list:
    out = []
    if "error" in section:
        return out
    for model, eps in section.items():
        for addr, rec in eps.items():
            pipe = rec.get("pipeline") or {}
            causes = pipe.get("causes") or pipe.get("fractions") or {}
            if isinstance(causes, dict) and causes:
                def frac(v):
                    return v.get("fraction", 0.0) if isinstance(v, dict) else v
                dom = max(causes.items(), key=lambda kv: frac(kv[1]) or 0.0)
                out.append(_entry(
                    captured_at, "stall",
                    f"{model}@{addr}: dominant={dom[0]} "
                    f"({100 * (frac(dom[1]) or 0):.0f}%)"
                    + (
                        f" interpretation={pipe['interpretation']!r}"
                        if pipe.get("interpretation")
                        else ""
                    ),
                ))
            elif pipe.get("error"):
                out.append(_entry(
                    captured_at, "stall", f"{model}@{addr}: unreachable ({pipe['error']})"
                ))
    return out


def _fleet_entries(section: dict, captured_at: float) -> list:
    out = []
    for model, view in (section.get("models") or {}).items():
        agg = view.get("aggregate") or {}
        ratio = agg.get("prefix_hit_ratio")
        out.append(_entry(
            captured_at, "fleet",
            f"{model}: endpoints={agg.get('endpoints')} "
            f"(failed={agg.get('failed_endpoints')}) queue={agg.get('queue_depth')} "
            f"active={agg.get('active_slots')}/{agg.get('slots_total')} "
            f"tok/s={agg.get('tokens_per_second')} "
            f"headroom={agg.get('headroom_requests')} "
            f"prefix_hit_ratio={ratio if ratio is not None else 'n/a'}",
        ))
    return out


def _tenant_entries(section: dict, captured_at: float, limit: int = 6) -> list:
    """Heavy-hitter-ranked tenant breakdown at capture time: who was
    driving the traffic when the trigger fired (a tenant_flood names
    the hitter; any other trigger gets the context for free)."""
    out = []
    for row in (section.get("tenants") or [])[:limit]:
        req = row.get("requests") or {}
        tok = row.get("tokens") or {}
        cost = row.get("cost") or {}
        lat = row.get("latency") or {}
        line = (
            f"#{row.get('rank')} {row.get('tenant')}: share={row.get('share')}"
            f" window_req={req.get('window')} ({req.get('per_second')}/s)"
            f" tokens={tok.get('prompt')}p/{tok.get('completion')}c"
        )
        if lat.get("ttft_attainment") is not None:
            line += f" ttft_att={lat['ttft_attainment']:.3f}"
        if cost.get("kv_page_seconds"):
            line += f" kv_page_s={cost['kv_page_seconds']}"
        out.append(_entry(captured_at, "tenant", line))
    return out


def _log_entries(section: dict, limit: int = 25) -> list:
    """Recent WARNING+ structured log records interleaved into the
    timeline — each stamped with its own emit time, so the error log
    lands in sequence with the breaker flip it explains."""
    out = []
    for e in (section.get("records") or [])[:limit]:
        line = f"[{e.get('level')}] {e.get('logger')}: {e.get('message')}"
        tags = " ".join(
            f"{k}={e[k]}"
            for k in ("trace_id", "request_id", "model", "tenant", "qos_class")
            if e.get(k)
        )
        if tags:
            line += f" ({tags})"
        out.append(_entry(e.get("ts"), "log", line))
    evicted = section.get("evicted") or 0
    if evicted and out:
        out.append(_entry(
            out[-1][0], "log", f"(+{evicted} older records evicted from the ring)"
        ))
    return out


def _routing_entries(section: dict, captured_at: float) -> list:
    out = []
    for model, snap in sorted(section.items()):
        if not isinstance(snap, dict) or "endpoints" not in snap:
            continue
        eps = snap["endpoints"]
        picks = snap.get("recent_picks") or {}
        strat = ", ".join(
            f"{k}={v}" for k, v in sorted((picks.get("by_strategy") or {}).items())
        )
        line = (
            f"{model}: endpoints={len(eps)} picks={picks.get('total')}"
            + (f" ({strat})" if strat else "")
            + f" in_flight={snap.get('total_in_flight')}"
        )
        hot = max(
            eps, key=lambda e: e.get("load_factor") or 0.0, default=None
        )
        if hot is not None:
            line += (
                f" hottest={hot.get('name')}"
                f" load_factor={hot.get('load_factor')}"
                f" picks={hot.get('recent_picks')}"
                f" state={hot.get('breaker_state')}"
            )
        out.append(_entry(captured_at, "routing", line))
    return out


def _history_entries(section: dict, t0: float, limit: int = 12) -> list:
    """The pre-trigger window as sparklines: each curated series drawn
    over the captured context window, min..max annotated so the shape
    reads in absolute terms. Entries are stamped at the window START so
    they sort BEFORE the trigger — the timeline literally begins with
    what led up to it."""
    from kubeai_tpu_torch.obs.history import sparkline

    out = []
    since = section.get("since", t0)
    window = section.get("window_seconds")
    series = section.get("series") or {}
    # Widest dynamic range first: the series that MOVED are the story.
    def spread(rows):
        vals = [r[5] for r in (rows.get("points") or []) if isinstance(r, list)]
        if not vals:
            return -1.0
        lo, hi = min(vals), max(vals)
        return (hi - lo) / (abs(hi) + 1e-9)

    ranked = sorted(series.items(), key=lambda kv: -spread(kv[1]))
    shown = 0
    for name, rows in ranked:
        pts = rows.get("points") or []
        if not pts:
            continue
        if shown >= limit:
            out.append(_entry(
                since, "history",
                f"(+{len(ranked) - limit} more series in sections.history)",
            ))
            break
        shown += 1
        # Bucket the LAST values onto a fixed grid so gaps render as
        # holes; per-bucket max would also be defensible, but last
        # matches what an operator watching a gauge would have seen.
        step = rows.get("step_seconds") or 1.0
        until = section.get("until", t0)
        n_cells = max(min(int((until - since) / step) + 1, 60), 1)
        cells: list[float | None] = [None] * n_cells
        lo = hi = None
        for r in pts:
            idx = int((r[0] - since) / max((until - since) / n_cells, 1e-9))
            if 0 <= idx < n_cells:
                cells[idx] = r[5]
            lo = r[3] if lo is None else min(lo, r[3])
            hi = r[4] if hi is None else max(hi, r[4])
        out.append(_entry(
            since, "history",
            f"{name} [{lo:.4g}..{hi:.4g}] {sparkline(cells)}"
            + (f" ({window:.0f}s window)" if window else ""),
        ))
    for g in section.get("gaps") or []:
        out.append(_entry(
            g.get("since", since), "history",
            f"<gap: {g.get('reason')} "
            f"{max(g.get('until', 0) - g.get('since', 0), 0):.0f}s — no samples>",
        ))
    return out


def _forecast_entries(section: dict, t0: float) -> list:
    """Predicted band vs what actually arrived, per model/signal: the
    observed sparkline drawn against the forecast's recent curve, so a
    traffic_anomaly report shows the violation inline. Stamped at the
    recent window's start, like the history sparklines."""
    from kubeai_tpu_torch.obs.history import sparkline

    out = []
    for model, entry in sorted((section.get("models") or {}).items()):
        for signal, s in sorted((entry.get("signals") or {}).items()):
            recent = s.get("recent") or []
            if not recent:
                continue
            since = recent[0][0]
            obs_cells = [r[1] for r in recent]
            pred_cells = [r[2] for r in recent]
            lo_now, hi_now = recent[-1][3], recent[-1][4]
            acc = s.get("accuracy") or {}
            mape = acc.get("mape")
            out.append(_entry(
                since, "forecast",
                f"{model}/{signal} predicted {sparkline(pred_cells)} "
                f"band now [{lo_now:.4g}..{hi_now:.4g}]",
            ))
            out.append(_entry(
                since, "forecast",
                f"{model}/{signal} observed  {sparkline(obs_cells)} "
                f"anomaly_score={s.get('anomaly_score')}"
                + (f" mape={mape:.3f}" if isinstance(mape, (int, float)) else ""),
            ))
        if entry.get("disabled"):
            out.append(_entry(
                t0, "forecast",
                f"{model} forecast AUTO-DISABLED: {entry.get('disabled_reason')}",
            ))
    return out


def render_incident(doc: dict) -> str:
    """The human-readable correlated timeline for one incident doc."""
    t0 = doc.get("t", 0.0)
    sections = doc.get("sections", {})
    lines = [
        "=" * 72,
        f"INCIDENT {doc.get('id')}",
        f"  trigger:  {doc.get('trigger')}"
        + (f"  model={doc['model']}" if doc.get("model") else ""),
        f"  at:       {_fmt_t(t0)}",
        f"  detail:   {json.dumps(doc.get('detail', {}))}",
        f"  captured: {len(doc.get('sections_ok', []))}/{len(sections)} sections "
        f"in {doc.get('capture_seconds')}s"
        + (
            f", {doc['suppressed_repeats']} repeat trigger(s) debounced"
            if doc.get("suppressed_repeats")
            else ""
        ),
        f"  sections: {', '.join(sorted(sections))}",
        "=" * 72,
    ]
    entries: list = [_entry(t0, "TRIGGER", f"{doc.get('trigger')} {json.dumps(doc.get('detail', {}))}")]
    handlers = {
        "autoscaler": lambda s: _autoscaler_entries(s),
        "endpoints": lambda s: _breaker_entries(s, t0),
        "requests": lambda s: _trace_entries(s),
        "canary": lambda s: _canary_entries(s),
        "slo": lambda s: _slo_entries(s, t0),
        "engines": lambda s: _engine_entries(s, t0),
        "fleet": lambda s: _fleet_entries(s, t0),
        "routing": lambda s: _routing_entries(s, t0),
        "tenants": lambda s: _tenant_entries(s, t0),
        "history": lambda s: _history_entries(s, t0),
        "forecast": lambda s: _forecast_entries(s, t0),
        "logs": lambda s: _log_entries(s),
    }
    for name, fn in handlers.items():
        sec = sections.get(name)
        if isinstance(sec, dict) and "error" in sec and len(sec) == 1:
            entries.append(_entry(t0, name, f"<section capture failed: {sec['error']}>"))
            continue
        if sec is None:
            continue
        try:
            entries.extend(fn(sec))
        except Exception as e:  # a malformed section must not kill the report
            entries.append(_entry(t0, name, f"<render failed: {e}>"))
    # Time-ordered, offsets relative to the trigger. Entries without a
    # timestamp sink to the capture instant.
    entries = [(t if t is not None else t0, src, txt) for t, src, txt in entries]
    entries.sort(key=lambda e: e[0])
    lines.append("")
    lines.append("timeline (offsets relative to trigger):")
    for t, src, txt in entries:
        lines.append(f"  {t - t0:+9.2f}s  {src:<10s} {txt}")
    lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------------------


def _load_from_dir(incident_dir: str, incident_id: str | None):
    names = sorted(
        n for n in os.listdir(incident_dir)
        if n.startswith("incident-") and n.endswith(".json")
    )
    if incident_id:
        names = [n for n in names if incident_id in n]
    if not names:
        return None
    with open(os.path.join(incident_dir, names[-1])) as f:
        return json.load(f)


def _load_from_url(base: str, incident_id: str | None):
    import urllib.request

    base = base.rstrip("/")
    if incident_id is None:
        with urllib.request.urlopen(base + "/debug/incidents", timeout=10) as r:
            listing = json.load(r)
        incidents = listing.get("incidents") or []
        if incidents:
            incident_id = incidents[0]["id"]
        else:
            # Memory ring empty (fresh operator restart) — the disk
            # index is how the surviving evidence is discovered.
            disk = listing.get("disk") or []
            if not disk:
                return None
            incident_id = disk[0]
    with urllib.request.urlopen(
        base + f"/debug/incidents?id={incident_id}", timeout=10
    ) as r:
        return json.load(r)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        "kubeai-incident-report",
        description="Render a captured incident snapshot as a correlated timeline.",
    )
    parser.add_argument(
        "--dir", default=None,
        help=f"incident ring directory (default $KUBEAI_INCIDENT_DIR or {incident_dir_default()})",
    )
    parser.add_argument("--url", default=None, help="live operator base URL instead of a directory")
    parser.add_argument("--id", default=None, help="incident id (default: the latest)")
    parser.add_argument("--list", action="store_true", help="index the ring instead of rendering")
    parser.add_argument("--json", action="store_true", help="emit the raw incident document")
    args = parser.parse_args(argv)

    incident_dir = args.dir or incident_dir_default()
    if args.list:
        if args.url:
            import urllib.request

            with urllib.request.urlopen(
                args.url.rstrip("/") + "/debug/incidents", timeout=10
            ) as r:
                listing = json.load(r)
            rows = listing.get("incidents") or []
            if not rows:
                # Restarted operator: index the surviving disk ring
                # (id layout: <epoch-ms>-<seq>-<trigger>).
                for i in listing.get("disk") or []:
                    parts = i.split("-", 2)
                    try:
                        t = int(parts[0]) / 1000.0
                    except ValueError:
                        t = 0.0
                    rows.append({
                        "id": i, "t": t,
                        "trigger": parts[2] if len(parts) > 2 else "?",
                    })
        else:
            rows = []
            if os.path.isdir(incident_dir):
                for n in sorted(os.listdir(incident_dir), reverse=True):
                    if n.startswith("incident-") and n.endswith(".json"):
                        try:
                            with open(os.path.join(incident_dir, n)) as f:
                                d = json.load(f)
                        except (OSError, ValueError):
                            continue
                        rows.append(d)
        for d in rows:
            print(
                f"{d.get('id')}  {_fmt_t(d.get('t', 0))}  trigger={d.get('trigger')}"
                + (f"  model={d['model']}" if d.get("model") else "")
            )
        if not rows:
            print("no incidents recorded", file=sys.stderr)
            return 1
        return 0

    if args.url:
        doc = _load_from_url(args.url, args.id)
    elif os.path.isdir(incident_dir):
        doc = _load_from_dir(incident_dir, args.id)
    else:
        doc = None
    if doc is None:
        print(
            f"no incident found (dir={incident_dir!r}, url={args.url!r}, id={args.id!r})",
            file=sys.stderr,
        )
        return 1
    if args.json:
        print(json.dumps(doc, indent=1))
    else:
        print(render_incident(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
