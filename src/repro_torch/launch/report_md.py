"""The census (DiscriminantSweep) anomaly-rate tables in the style of the
paper's Figs. 5-7 — a copy of the census half of the reference's
``repro.launch.report_md``. The explain tables refuse until explain is
ported; the roofline and perf tables of the reference's dry runs are not
part of the port yet."""


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


def explain_tables(records, name: str = "explain") -> str:
    """Markdown cause tables from merged AnomalyExplainer records — refused
    until explain is ported."""
    from repro_torch.core.stores import NotPortedError, not_ported

    raise NotPortedError(f"explain tables: {not_ported('explain')}")
