"""Run a chaos campaign over the port's stack on the card (or ``--device
cpu``) and write its document to ``<out>/CHAOS.json``.

    python -m kubeai_tpu_torch.chaos --episodes 4 --seed 1 --replicas 2
    python -m kubeai_tpu_torch.chaos --induce            # prove detect + shrink + replay
    python -m kubeai_tpu_torch.chaos --seed 1 --replay-episode 7

The document adds to the schema: ``launches`` (each kernel wrapper's
launches during the episodes, counted from 0 after the stack's build and
references), ``build_s``, and with ``--induce`` an ``induced`` block (the
violations, the shrunk schedule, and the violations of its replay). Exit
status 0 when every seeded episode is clean (and, with ``--induce``, the
induced schedule was detected, shrunk and still violates on replay).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from kubeai_tpu_torch.chaos.campaign import ChaosCampaign, induced_schedule
from kubeai_tpu_torch.chaos.report import validate_chaos_doc
from kubeai_tpu_torch.chaos.schedule import Schedule, generate_schedule
from kubeai_tpu_torch.ops import read_launches, zero_launches

def main(argv=None) -> int:
    ap = argparse.ArgumentParser("python -m kubeai_tpu_torch.chaos", description=__doc__.split("\n")[0])
    ap.add_argument("--episodes", type=int, default=None,
                    help="episodes (default KUBEAI_CHAOS_EPISODES or 200)")
    ap.add_argument("--seed", type=int, default=None, help="default KUBEAI_CHAOS_SEED or 1")
    ap.add_argument("--replicas", type=int, default=None,
                    help="engine replicas (default KUBEAI_CHAOS_REPLICAS or 3)")
    ap.add_argument("--requests", type=int, default=None,
                    help="streams an episode (default KUBEAI_CHAOS_REQUESTS or 8)")
    ap.add_argument("--device", default=None, help="the engines' device (default cuda)")
    ap.add_argument("--out", default=os.path.join("build", "chaos"),
                    help="directory for CHAOS.json and the campaign's history and incidents")
    ap.add_argument("--induce", action="store_true",
                    help="after the episodes, run induced_schedule(): it must be detected, "
                         "shrunk, and its shrunk schedule must violate again on replay")
    ap.add_argument("--replay-episode", type=int, default=None, metavar="N",
                    help="run only episode N of --seed (-1: the induced schedule)")
    ap.add_argument("--replay-schedule", default=None, metavar="FILE",
                    help="run only a schedule's JSON (a reduced_schedule block)")
    args = ap.parse_args(argv)

    if args.device in (None, "cuda"):
        import torch

        # Streams are compared byte for byte across batch shapes.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kwargs = {k: v for k, v in (("episodes", args.episodes), ("seed", args.seed),
                                ("replicas", args.replicas),
                                ("requests_per_episode", args.requests)) if v is not None}
    campaign = ChaosCampaign(out_dir=args.out, device=args.device, **kwargs)
    replay = None
    if args.replay_schedule:
        with open(args.replay_schedule) as f:
            replay = Schedule.from_dict(json.load(f))
    elif args.replay_episode is not None:
        replay = (induced_schedule(campaign.seed) if args.replay_episode < 0
                  else generate_schedule(campaign.seed, args.replay_episode, campaign.replicas))
    print(f"chaos: seed={campaign.seed} episodes={campaign.episodes} "
          f"replicas={campaign.replicas} requests/ep={campaign.requests} "
          f"device={args.device or 'cuda'}", flush=True)
    t0 = time.monotonic()
    with campaign:
        build_s = time.monotonic() - t0
        zero_launches()
        if replay is not None:
            print(f"replaying: {replay.describe()}")
            res = campaign.run_episode(replay)
            for v in res["violations"]:
                print(f"  - {v}")
            print("violations reproduced" if res["violations"] else "clean on replay")
            return 1 if res["violations"] else 0
        doc = campaign.run()
        doc["launches"] = read_launches()
        if args.induce:
            sched = induced_schedule(campaign.seed)
            t_ind = time.monotonic()
            found = campaign.run_episode(sched)["violations"]
            induced = {"violations": found}
            if found:
                events, runs = campaign.shrink(sched)
                reduced = Schedule(seed=sched.seed, episode=sched.episode, events=events)
                induced.update({
                    "reduced_schedule": reduced.to_dict(), "shrink_runs": runs,
                    "replay_violations": campaign.run_episode(reduced, tag="-replay")[
                        "violations"]})
            induced["seconds"] = round(time.monotonic() - t_ind, 2)
            doc["induced"] = induced
    doc["build_s"] = round(build_s, 2)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "CHAOS.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    print(f"{doc['episodes']} episodes in {doc['duration_s']}s (build {doc['build_s']}s); "
          f"sites fired {doc['sites_fired']}; wrote {path}")
    for v in doc["violations"]:
        print(f"violation in episode {v['episode']}: {v['violations']}; replay: {v['replay']}")
    problems = validate_chaos_doc(doc, require_clean=True)
    induced = doc.get("induced")
    if args.induce and not (induced and induced.get("replay_violations")):
        problems.append(f"the induced schedule was not detected, shrunk and replayed: {induced}")
    for p in problems:
        print(f"  - {p}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
