"""The census (DiscriminantSweep) anomaly-rate tables in the style of the
paper's Figs. 5-7, the learned cost model's prediction-error tables and
the AnomalyExplainer's cause tables — a copy of the census, predict and
explain parts of the reference's ``repro.launch.report_md``. The roofline
and perf tables of the reference's dry runs have no counterpart in the
port."""


def _census_agg_row(label: str, a: dict) -> str:
    reasons = a.get("reasons", {})
    return (
        f"| {label} | {a['n']} | {a['anomalies']} | {100.0 * a['rate']:.1f}% | "
        f"{reasons.get('min_flops_split', 0)} | "
        f"{reasons.get('faster_outside_min_flops', 0)} | "
        f"{a['converged']}/{a['n']} |"
    )


_CENSUS_HEADER = (
    "| {col} | n | anomalies | rate | S_F split | faster outside S_F | "
    "converged |\n|---|---|---|---|---|---|---|"
)


def _family_notes(by_family) -> list:
    """One italic footnote per censused family, from the AlgorithmFamily
    registry's descriptions (families a reader of the report cannot be
    assumed to know, e.g. kernel_variants). Unregistered family names in
    old stores are skipped silently."""
    from repro_torch.core.family import get_family

    notes = []
    for fam in by_family:
        try:
            desc = get_family(fam).description
        except KeyError:
            continue
        if desc:
            notes.append(f"*{fam}*: {desc}.")
    return notes


def census_tables(records, name: str = "census") -> str:
    """Markdown anomaly-rate tables (overall / by family / by instance size
    / family x size) from merged DiscriminantSweep records — the paper's
    Figs. 5-7 presentation of "an abundance of anomalies"."""
    from repro_torch.core.sweep import census_summary

    s = census_summary(records)
    total = s["total"]
    out = [
        f"## Census `{name}` — FLOPs-discriminant anomaly rate",
        "",
        f"{total['n']} instances, {total['anomalies']} anomalies "
        f"({100.0 * total['rate']:.1f}%), "
        f"{total['converged']}/{total['n']} campaigns converged.",
        "",
    ]
    n_pred = total.get("predicted", 0)
    if n_pred:
        out += [
            f"{n_pred}/{total['n']} instances predicted without measurement "
            f"by the learned cost model (skip fraction "
            f"{100.0 * n_pred / max(total['n'], 1):.1f}%); the rest were "
            "measured normally.",
            "",
        ]
    out += [
        "### By expression family",
        "",
        _CENSUS_HEADER.format(col="family"),
    ]
    for fam, a in s["by_family"].items():
        out.append(_census_agg_row(fam, a))
    notes = _family_notes(s["by_family"])
    if notes:
        out += [""] + notes
    out += ["", "### By instance size (geometric-mean dimension)", "",
            _CENSUS_HEADER.format(col="size")]
    for bucket, a in s["by_size"].items():
        out.append(_census_agg_row(f"`{bucket}`", a))
    out += ["", "### Family x size", "",
            _CENSUS_HEADER.format(col="family / size")]
    for fam, buckets in s["by_family_size"].items():
        for bucket, a in buckets.items():
            out.append(_census_agg_row(f"{fam} `{bucket}`", a))
    return "\n".join(out) + "\n"


def predict_tables(rows, name: str = "predict") -> str:
    """Markdown prediction-error tables from
    :func:`repro_torch.predict.active.prediction_errors` rows: per
    (family, machine) the mean absolute log10-time error against the
    deterministic ground truth, winner/anomaly agreement with the census
    verdicts, and the fraction the confidence gate would skip."""
    groups = {}
    for r in rows:
        groups.setdefault((r["family"], r["machine"]), []).append(r)
    n_skip = sum(1 for r in rows if r["skipped"])
    out = [
        f"## Predictor `{name}` — learned cost model vs the census",
        "",
        f"{len(rows)} instances scored; the confidence gate would skip "
        f"{n_skip} ({100.0 * n_skip / max(len(rows), 1):.1f}%) without "
        "measurement.",
        "",
        "| family | machine | n | mean |Δlog10 t| | winner match | "
        "anomaly match | would skip |",
        "|---|---|---|---|---|---|---|",
    ]
    for (fam, machine), g in sorted(groups.items()):
        errs = [r["abs_dlog10_t"] for r in g if r["abs_dlog10_t"] is not None]
        err = f"{sum(errs) / len(errs):.4f}" if errs else "—"
        wins = sum(1 for r in g if r["winner_match"])
        anoms = sum(1 for r in g if r["anomaly_match"])
        skips = sum(1 for r in g if r["skipped"])
        out.append(
            f"| {fam} | {machine} | {len(g)} | {err} | "
            f"{wins}/{len(g)} | {anoms}/{len(g)} | "
            f"{100.0 * skips / len(g):.1f}% |"
        )
    return "\n".join(out) + "\n"


def explain_tables(records, name: str = "explain") -> str:
    """Markdown cause tables from merged AnomalyExplainer records: cause
    rates with evidence, family x cause, offending-kernel tally, and the
    highest-evidence examples — the census anomalies, explained."""
    from repro_torch.explain.runner import explain_summary

    s = explain_summary(records)
    out = [
        f"## Explanations `{name}` — anomaly root causes",
        "",
        f"{s['total']} anomalies explained, mean evidence "
        f"{s['mean_evidence']:.2f} (fraction of the winner/loser time gap "
        "the assigned cause accounts for).",
        "",
        "### By cause",
        "",
        "| cause | n | share | mean evidence |",
        "|---|---|---|---|",
    ]
    for cause, a in s["by_cause"].items():
        out.append(f"| {cause} | {a['n']} | {100.0 * a['share']:.1f}% | "
                   f"{a['mean_evidence']:.2f} |")
    out += ["", "### Family x cause", "",
            "| family | cause | n | mean evidence |", "|---|---|---|---|"]
    for fam, causes in s["by_family_cause"].items():
        for cause, a in causes.items():
            out.append(f"| {fam} | {cause} | {a['n']} | "
                       f"{a['mean_evidence']:.2f} |")
    if s["offending_ops"]:
        out += ["", "### Offending kernels", "",
                "| kernel op | anomalies it explains |", "|---|---|"]
        for op, n in sorted(s["offending_ops"].items(),
                            key=lambda kv: (-kv[1], kv[0])):
            out.append(f"| {op} | {n} |")
    top = sorted(records, key=lambda r: (-float(r["evidence"]), r["index"]))[:5]
    if top:
        out += ["", "### Highest-evidence examples", "",
                "| uid | reason | cause | evidence | offending kernel/pair | "
                "gap | gap z | flip p | modes |",
                "|---|---|---|---|---|---|---|---|---|"]
        for r in top:
            z = r.get("gap_zscore")
            flip = r.get("flip_probability")
            modes = (r.get("bimodality") or {}).get("share")
            out.append(
                f"| {r['uid']} | {r['reason']} | {r['cause']} | "
                f"{float(r['evidence']):.2f} | "
                f"{r.get('offending_kernel') or '—'} | "
                f"{100.0 * float(r['gap_rel']):.1f}% | "
                f"{f'{float(z):.1f}' if z is not None else '—'} | "
                f"{f'{float(flip):.2f}' if flip is not None else '—'} | "
                f"{f'{100.0 * float(modes):.0f}%' if modes is not None else '—'} |"
            )
    return "\n".join(out) + "\n"
