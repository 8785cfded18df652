"""Join the health plane's artifacts into one schema-guarded report.

    python -m fedcrack_tpu_torch.tools.health_report --ledger ledger.jsonl \
        --canary canary.json --drift drift.json --privacy privacy.json --out report.json

The counterpart of ``fedcrack_tpu.tools.health_report``. It joins the
per-client update ledger (``health.ledger.write_ledger_jsonl``), a canary
IoU history (``{"history": [CanaryEvaluator records], ...}``), a drift
comparison (``health.drift.write_drift_json``) and a privacy summary (a
JSON file, read as it is) into one document: who offered what, who was
flagged or quarantined, how the canary IoU moved across versions, which
traffic signals drifted and what privacy budget was spent.

The report is validated against the typed contract below before it is
written (:func:`validate_report`), and the command exits 1 on any
violation: a malformed ledger row, a canary IoU outside [0, 1], a
non-finite PSI or epsilon, a ``max_epsilon`` that is not the maximum of
its own rows, or a conservation break (offers != accepted + rejected +
resyncs).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from fedcrack_tpu_torch.health.ledger import (
    ANOMALY_ALERT,
    conservation,
    read_ledger_jsonl,
)

# Typed contracts: key -> isinstance types.
LEDGER_ROW_SCHEMA = {
    "offers": int,
    "accepted": int,
    "resyncs": int,
    "samples": int,
    "wire_bytes": int,
    "rejected": dict,
    "last_round": int,
    "last_staleness": int,
    "norms": list,
    "cosines": list,
    "anomaly": (int, float),
    "flags": int,
    # Flushes this client was excluded from by the ledger-coupled
    # quarantine.
    "quarantined": int,
}
CANARY_EVAL_SCHEMA = {
    "version": int,
    "iou": (int, float),
    "per_bucket": dict,
    "reference_version": int,
    "probe_batch": int,
    "probe_seed": int,
}
# The privacy summary (the JAX package's ``fed.rounds.privacy_summary``, as
# its server's ``--privacy-summary`` writes it): the budget the federation
# spent, beside who spent it.
PRIVACY_DP_SCHEMA = {
    "enabled": bool,
    "clip_norm": (int, float),
    "noise_multiplier": (int, float),
    "sample_rate": (int, float),
    "delta": (int, float),
    "epsilon_budget": (int, float),
    "clients": dict,
    "max_epsilon": (int, float),
}
PRIVACY_CLIENT_SCHEMA = {
    "steps": int,
    "epsilon": (int, float),
}
PRIVACY_SECAGG_SCHEMA = {
    "enabled": bool,
    "bits": int,
    "roster_size": int,
}
SUMMARY_SCHEMA = {
    "clients": int,
    "offers": int,
    "accepted": int,
    "rejected": int,
    "resyncs": int,
    "flagged_clients": list,
    "max_anomaly": (int, float),
    "conservation_violations": list,
    "quarantines": int,
    "quarantined_clients": list,
}


def build_report(
    ledger_path: str,
    canary_path: str | None = None,
    drift_path: str | None = None,
    privacy_path: str | None = None,
) -> dict:
    """The joined report (deterministic: sorted clients, no timestamps).
    The canary/drift/privacy sections are None when their artifact is not
    given — absence, not an empty-but-plausible block."""
    ledger = read_ledger_jsonl(ledger_path)
    cons = conservation(ledger)
    clients = {}
    for name in sorted(ledger):
        rec = dict(ledger[name])
        rec["flagged"] = float(rec.get("anomaly", 0.0)) >= ANOMALY_ALERT
        clients[name] = rec
    summary = {
        "clients": len(ledger),
        "offers": sum(r["offers"] for r in ledger.values()),
        "accepted": sum(r["accepted"] for r in ledger.values()),
        "rejected": sum(
            sum(r["rejected"].values()) for r in ledger.values()
        ),
        "resyncs": sum(r["resyncs"] for r in ledger.values()),
        "flagged_clients": sorted(
            n for n, r in clients.items() if r["flagged"]
        ),
        "max_anomaly": max(
            (float(r.get("anomaly", 0.0)) for r in ledger.values()),
            default=0.0,
        ),
        "conservation_violations": cons["violations"],
        # How many flush-time exclusions the quarantine made, and for
        # whom: beside each client's `flagged` bit, detection and
        # exclusion in one report.
        "quarantines": sum(
            int(r.get("quarantined", 0)) for r in ledger.values()
        ),
        "quarantined_clients": sorted(
            n for n, r in ledger.items() if int(r.get("quarantined", 0)) > 0
        ),
    }
    canary = None
    if canary_path:
        with open(canary_path, encoding="utf-8") as f:
            canary = json.load(f)
    drift = None
    if drift_path:
        with open(drift_path, encoding="utf-8") as f:
            doc = json.load(f)
        psis = doc.get("psi") or {}
        drift = {
            "psi": {k: float(psis[k]) for k in sorted(psis)},
            "max_psi": max((float(v) for v in psis.values()), default=0.0),
            "signals": sorted({k.split("/", 1)[1] for k in psis}),
            "buckets": sorted({k.split("/", 1)[0] for k in psis}),
        }
    privacy = None
    if privacy_path:
        with open(privacy_path, encoding="utf-8") as f:
            privacy = json.load(f)
    return {
        "generated_by": "fedcrack_tpu_torch.tools.health_report",
        "anomaly_alert": ANOMALY_ALERT,
        "clients": clients,
        "summary": summary,
        "canary": canary,
        "drift": drift,
        "privacy": privacy,
    }


def _typed(block: dict, schema: dict, where: str, bad: list) -> None:
    for key, typ in schema.items():
        if key not in block:
            bad.append(f"{where}[{key!r}] missing")
        elif typ is bool:
            # A declared-bool field wants a REAL bool (the privacy block's
            # `enabled` flags) — ints masquerading as flags fail.
            if not isinstance(block[key], bool):
                bad.append(
                    f"{where}[{key!r}] is {type(block[key]).__name__}, "
                    "wants bool"
                )
        elif isinstance(block[key], bool) or not isinstance(block[key], typ):
            bad.append(
                f"{where}[{key!r}] is {type(block[key]).__name__}, wants {typ}"
            )


def validate_report(report: dict) -> list:
    """Contract violations (empty = clean) — shared by the CLI's exit-code
    gate and the tier-1 guard test, so the contract cannot drift from the
    code that writes it."""
    bad: list[str] = []
    clients = report.get("clients")
    if not isinstance(clients, dict):
        return [f"clients is {type(clients).__name__}, wants dict"]
    for name in sorted(clients):
        rec = clients[name]
        _typed(rec, LEDGER_ROW_SCHEMA, f"clients[{name!r}]", bad)
        rejected = rec.get("rejected")
        n_rejected = (
            sum(int(v) for v in rejected.values())
            if isinstance(rejected, dict)
            else 0
        )
        if isinstance(rec.get("offers"), int) and rec["offers"] != (
            rec.get("accepted", 0) + n_rejected + rec.get("resyncs", 0)
        ):
            bad.append(
                f"clients[{name!r}] conservation: offers != "
                "accepted + rejected + resyncs"
            )
        for window in ("norms", "cosines"):
            for x in rec.get(window) or []:
                if not isinstance(x, (int, float)) or not math.isfinite(x):
                    bad.append(f"clients[{name!r}][{window!r}] non-finite")
                    break
    summary = report.get("summary")
    if isinstance(summary, dict):
        _typed(summary, SUMMARY_SCHEMA, "summary", bad)
    else:
        bad.append(f"summary is {type(summary).__name__}, wants dict")
    canary = report.get("canary")
    if canary is not None:
        history = canary.get("history") if isinstance(canary, dict) else None
        if not isinstance(history, list):
            bad.append("canary.history missing or not a list")
        else:
            for i, ev in enumerate(history):
                _typed(ev, CANARY_EVAL_SCHEMA, f"canary.history[{i}]", bad)
                iou = ev.get("iou")
                if isinstance(iou, (int, float)) and not (
                    math.isfinite(iou) and 0.0 <= iou <= 1.0
                ):
                    bad.append(f"canary.history[{i}].iou not a unit value")
    privacy = report.get("privacy")
    if privacy is not None:
        dp = privacy.get("dp") if isinstance(privacy, dict) else None
        sa = privacy.get("secagg") if isinstance(privacy, dict) else None
        if not isinstance(dp, dict):
            bad.append("privacy.dp missing or not a dict")
        else:
            _typed(dp, PRIVACY_DP_SCHEMA, "privacy.dp", bad)
            pclients = dp.get("clients")
            if isinstance(pclients, dict):
                for name in sorted(pclients):
                    rec = pclients[name]
                    where = f"privacy.dp.clients[{name!r}]"
                    if not isinstance(rec, dict):
                        bad.append(f"{where} not a dict")
                        continue
                    _typed(rec, PRIVACY_CLIENT_SCHEMA, where, bad)
                    eps = rec.get("epsilon")
                    if isinstance(eps, (int, float)) and not (
                        math.isfinite(eps) and eps >= 0.0
                    ):
                        bad.append(f"{where}.epsilon not finite-nonnegative")
                # The headline must AGREE with the per-client ledger: a
                # max_epsilon that is not the max of its own rows is a
                # privacy accounting bug, the one class this report exists
                # to catch.
                worst = max(
                    (
                        float(r.get("epsilon", 0.0))
                        for r in pclients.values()
                        if isinstance(r, dict)
                        and isinstance(r.get("epsilon"), (int, float))
                    ),
                    default=0.0,
                )
                got = dp.get("max_epsilon")
                if isinstance(got, (int, float)) and not math.isclose(
                    float(got), worst, rel_tol=1e-9, abs_tol=1e-9
                ):
                    bad.append(
                        f"privacy.dp.max_epsilon {got} != per-client max "
                        f"{worst}"
                    )
        if not isinstance(sa, dict):
            bad.append("privacy.secagg missing or not a dict")
        else:
            _typed(sa, PRIVACY_SECAGG_SCHEMA, "privacy.secagg", bad)
    drift = report.get("drift")
    if drift is not None:
        psis = drift.get("psi") if isinstance(drift, dict) else None
        if not isinstance(psis, dict):
            bad.append("drift.psi missing or not a dict")
        else:
            for key in sorted(psis):
                v = psis[key]
                if "/" not in key:
                    bad.append(f"drift.psi[{key!r}] not '<bucket>/<signal>'")
                if not isinstance(v, (int, float)) or not math.isfinite(v):
                    bad.append(f"drift.psi[{key!r}] non-finite")
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m fedcrack_tpu_torch.tools.health_report", description=__doc__
    )
    p.add_argument("--ledger", required=True, help="ledger JSONL path")
    p.add_argument("--canary", default="", help="canary history JSON path")
    p.add_argument("--drift", default="", help="drift profile JSON path")
    p.add_argument(
        "--privacy", default="",
        help="privacy summary JSON path (server.py --privacy-summary)",
    )
    p.add_argument("--out", default="", help="write the joined report here")
    args = p.parse_args(argv)
    report = build_report(
        args.ledger, args.canary or None, args.drift or None,
        args.privacy or None,
    )
    violations = validate_report(report)
    payload = json.dumps(report, indent=1, sort_keys=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(payload + "\n")
        print(f"wrote {args.out}")
        print(json.dumps(report["summary"], indent=1, sort_keys=True))
    else:
        print(payload)
    if violations:
        for v in violations:
            print(f"SCHEMA {v}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
