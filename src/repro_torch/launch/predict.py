"""Learned cost model launcher — train / predict / eval for active censuses.

Train a ridge model (:mod:`repro_torch.predict`) from a finished deterministic
census, inspect its per-instance rank predictions, and score it against a
measured census (the pred-error tables):

    # fit the model from a merged census store
    PYTHONPATH=src python -m repro_torch predict train \\
        --census /tmp/census --out /tmp/model.json

    # per-instance predicted ranking + confidence (what the gate would do)
    PYTHONPATH=src python -m repro_torch predict predict \\
        --census /tmp/census --model /tmp/model.json

    # pred-error tables per family/machine against the measured records
    PYTHONPATH=src python -m repro_torch predict eval \\
        --census /tmp/census --model /tmp/model.json

The trained JSON is what ``repro_torch census run --predictor MODEL.json``
consults to skip confidently-predicted instances, and what
``repro_torch oracle warm --model MODEL.json`` serves cache misses from.
Training targets exist only for the deterministic backends
(``cost_model`` / ``simulated``): those records' measured outcomes are
reconstructible bit-exactly from their rebuild pointers. Wall-clock
records are skipped at train time and the count is reported.

No verb touches a device. A copy of the reference's
``repro.launch.predict``: what it prints and writes is the reference's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _load_census(census: str):
    from repro_torch.core.sweep import SweepSpec, merge_shards

    spec = SweepSpec.load(os.path.join(census, "spec.json"))
    return spec, merge_shards(spec, census)


def cmd_train(args: argparse.Namespace) -> int:
    from repro_torch.predict.model import train_model

    spec, records = _load_census(args.census)
    if not records:
        print("# census has no completed records — run it first",
              file=sys.stderr)
        return 1
    try:
        model = train_model(spec, records, machine=args.machine,
                            alpha=args.alpha)
    except ValueError as err:
        print(f"# {err}", file=sys.stderr)
        return 1
    model.save(args.out)
    skipped = (f", {model.n_skipped} wall-clock records skipped"
               if model.n_skipped else "")
    print(f"# trained {args.out}: {model.n_train} (instance, algorithm) "
          f"rows{skipped}, machine {model.machine}, residual sigma "
          f"{model.residual_sigma:.4f} (log10 s), "
          f"digest {model.train_digest[:12]}")
    return 0


def cmd_predict(args: argparse.Namespace) -> int:
    from repro_torch.predict.active import ActivePredictor

    spec, _ = _load_census(args.census)
    threshold = args.threshold if args.threshold is not None \
        else spec.predict_threshold
    predictor = ActivePredictor.open(
        args.model, spec, threshold=threshold, machine=args.machine,
    )
    instances = spec.expand()
    skipped = 0
    rows = []
    for inst in instances:
        pred = predictor.predict(inst)
        skip = pred.confidence >= predictor.threshold
        skipped += skip
        if args.json:
            rows.append(json.dumps(
                predictor.record(inst, pred), sort_keys=True,
                separators=(",", ":"),
            ))
        else:
            order = sorted(pred.ranks, key=lambda a: (pred.ranks[a], a))
            anom = f" ANOMALY({pred.reason})" if pred.is_anomaly else ""
            rows.append(
                f"# {inst.uid}: {' < '.join(order)} "
                f"conf={pred.confidence:.3f}"
                f" [{'skip' if skip else 'measure'}]{anom}"
            )
    print("\n".join(rows))
    frac = skipped / max(len(instances), 1)
    print(f"# gate at threshold {predictor.threshold}: {skipped}"
          f"/{len(instances)} instances would skip measurement "
          f"({100.0 * frac:.1f}%)", file=sys.stderr)
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    from repro_torch.launch.report_md import predict_tables
    from repro_torch.predict.active import prediction_errors
    from repro_torch.predict.model import RidgeModel

    spec, records = _load_census(args.census)
    if not records:
        print("# census has no completed records — run it first",
              file=sys.stderr)
        return 1
    model = RidgeModel.load(args.model)
    rows = prediction_errors(spec, records, model, machine=args.machine)
    if args.json:
        json.dump(rows, sys.stdout, indent=1, sort_keys=True)
        print()
    else:
        print(predict_tables(rows, name=spec.name))
    return 0


def main(argv: Optional[List[str]] = None, prog: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog=prog or "repro_torch predict",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="fit the ridge model from a finished "
                       "deterministic census")
    p.add_argument("--census", required=True, help="census store root")
    p.add_argument("--out", required=True, help="model JSON to write")
    p.add_argument("--machine", default="",
                   help="MachineSpec registry name to cost features against "
                   "(default: derived from the census backend)")
    p.add_argument("--alpha", type=float, default=1e-3,
                   help="ridge regularization strength")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("predict", help="per-instance predicted ranking, "
                       "confidence, and the gate's skip/measure decision")
    p.add_argument("--census", required=True, help="census store root")
    p.add_argument("--model", required=True, help="trained model JSON")
    p.add_argument("--threshold", type=float, default=None,
                   help="confidence gate (default: the spec's "
                   "predict_threshold)")
    p.add_argument("--machine", default="")
    p.add_argument("--json", action="store_true",
                   help="emit predicted-provenance census records (JSONL) "
                   "instead of the table")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("eval", help="pred-error tables per family/machine "
                       "against the measured census records")
    p.add_argument("--census", required=True, help="census store root")
    p.add_argument("--model", required=True, help="trained model JSON")
    p.add_argument("--machine", default="")
    p.add_argument("--json", action="store_true",
                   help="raw evaluation rows as JSON instead of markdown")
    p.set_defaults(fn=cmd_eval)

    args = ap.parse_args(argv)
    return args.fn(args)
