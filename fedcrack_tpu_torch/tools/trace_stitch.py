"""Stitch per-process span JSONL files into end-to-end update lifecycles.

``python -m fedcrack_tpu_torch.tools.trace_stitch spans_a.jsonl spans_b.jsonl
--require client.push,fed.flush,serve.swap,serve.batch --json stitched.json``

The counterpart of ``fedcrack_tpu.tools.trace_stitch``, pure JSONL
processing: it reads span files written by either package. Each process
records spans to its own JSONL (``obs/spans.py``); an update's lifecycle
shatters across those files the moment it hits the wire. This tool joins
them back together on the propagation contract:

- **intra-process** edges via the recorder's local ``span``/``parent`` ids
  (e.g. ``client.train`` → ``client.push``), scoped per source file;
- **cross-process** edges via wire contexts: a span's ``ctx`` attribute is
  its ``"<trace>#<key>"`` identity, and downstream spans reference it as
  ``remote_parent`` (one upstream) or ``links`` (fan-in — a flush lists
  every contributing push, an edge flush lists its leaf offers);
- **deterministic flush/swap keys**: the flush publishing version ``V`` is
  ``flush:vV`` in trace ``fedtr-v(V-1)`` by construction, so a
  ``serve.swap`` span's ``remote_parent`` resolves even though the serve
  process never spoke to the federation — it read the version off the
  statefile.

A **chain** is anchored at each ``fed.flush`` span: its resolved upstream
(pushes → their local train parents; edge flushes → their leaf offers) plus
its downstream (the ``serve.swap`` installing the published version and the
first ``serve.batch`` answered from it). ``chain["complete"]`` means the
full ``client → root → serve`` lifecycle resolved under the flush's single
trace id; ``planes_crossed`` is the set of span-name prefixes on the chain
(``client``/``edge``/``fed``/``serve`` — one per process plane in a
multi-process deployment). A context that was dropped or corrupted on the
wire simply fails to resolve: the chain reports it missing, nothing raises.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterable

from fedcrack_tpu_torch.obs.spans import TraceContext, span_files


def load_records(paths: Iterable[str]) -> list[dict]:
    """All span records from the given JSONL files (each expanded to its
    rotation set oldest-first), tagged with their source file. Unparseable
    lines are skipped with a count — a half-written final line from a
    killed process must not sink the whole post-mortem."""
    records: list[dict] = []
    for given in paths:
        for path in span_files(given) or [given]:
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if isinstance(rec, dict):
                            rec["_file"] = path
                            records.append(rec)
            except FileNotFoundError:
                continue
    return records


def _by_ctx(records: list[dict]) -> dict[str, dict]:
    """wire-context string -> span record (first writer wins; duplicate
    contexts are a sender bug the summary surfaces, not a crash)."""
    out: dict[str, dict] = {}
    for rec in records:
        ctx = rec.get("ctx")
        if isinstance(ctx, str) and ctx and ctx not in out:
            out[ctx] = rec
    return out


def _by_local_id(records: list[dict]) -> dict[tuple, dict]:
    """(file, span_id) -> record: recorder-local ids are unique per file,
    ambiguous across files — same indexing discipline as ``_by_ctx`` (a
    linear scan per parent lookup would make stitching an hours-long
    soak's span set quadratic)."""
    out: dict[tuple, dict] = {}
    for rec in records:
        span_id = rec.get("span")
        if span_id is not None:
            out.setdefault((rec.get("_file"), span_id), rec)
    return out


def _local_parent(rec: dict, local_index: dict[tuple, dict]) -> dict | None:
    """Resolve a record's recorder-local parent id within its own file."""
    parent = rec.get("parent")
    if not parent:
        return None
    return local_index.get((rec.get("_file"), parent))


def _resolved_links(rec: dict, ctx_index: dict[str, dict]) -> list[dict]:
    out = []
    for wire in rec.get("links") or []:
        if TraceContext.from_wire(wire) is None:
            continue
        hit = ctx_index.get(wire)
        if hit is not None:
            out.append(hit)
    return out


def _stage(rec: dict | None) -> dict | None:
    if rec is None:
        return None
    return {
        k: rec.get(k)
        for k in ("name", "trace", "span", "ctx", "t", "dur_s", "_file")
        if rec.get(k) is not None
    }


def stitch(records: list[dict]) -> dict:
    """Assemble chains (one per ``fed.flush`` span) and summary counters."""
    ctx_index = _by_ctx(records)
    local_index = _by_local_id(records)
    swaps_by_version: dict[int, dict] = {}
    first_batch_by_version: dict[int, dict] = {}
    for rec in records:
        if rec.get("name") == "serve.swap" and rec.get("installed", True):
            v = rec.get("to_version")
            if isinstance(v, int) and v not in swaps_by_version:
                swaps_by_version[v] = rec
        if rec.get("name") == "serve.batch":
            v = rec.get("model_version")
            if isinstance(v, int):
                prev = first_batch_by_version.get(v)
                if prev is None or rec.get("t", 0) < prev.get("t", 0):
                    first_batch_by_version[v] = rec

    chains = []
    for rec in records:
        if rec.get("name") != "fed.flush":
            continue
        version = rec.get("version")
        pushes = _resolved_links(rec, ctx_index)
        upstream = []
        for push in pushes:
            entry = {"span": _stage(push)}
            if push.get("name") == "edge.flush_partial":
                entry["leaves"] = [
                    _stage(leaf) for leaf in _resolved_links(push, ctx_index)
                ]
            else:
                entry["train"] = _stage(_local_parent(push, local_index))
            upstream.append(entry)
        swap = swaps_by_version.get(version) if isinstance(version, int) else None
        batch = (
            first_batch_by_version.get(version) if isinstance(version, int) else None
        )
        stage_records = (
            [u["span"] for u in upstream]
            + [t for u in upstream for t in [u.get("train")] if t]
            + [leaf for u in upstream for leaf in u.get("leaves", []) if leaf]
            + [_stage(rec), _stage(swap), _stage(batch)]
        )
        names = sorted({s["name"] for s in stage_records if s})
        planes = sorted({n.split(".", 1)[0] for n in names})
        # The single-trace-id contract: flush, swap and first batch all
        # carry the flush's trace, and at least one upstream (client/edge)
        # span does too.
        core_traces = {r.get("trace") for r in (rec, swap, batch) if r is not None}
        upstream_same = any(
            u["span"] and u["span"].get("trace") == rec.get("trace")
            for u in upstream
        )
        chain = {
            "trace": rec.get("trace"),
            "version": version,
            "round": rec.get("round"),
            "flush": _stage(rec),
            "upstream": upstream,
            "unresolved_links": [
                w
                for w in rec.get("links") or []
                if ctx_index.get(w) is None
            ],
            "swap": _stage(swap),
            "first_batch": _stage(batch),
            "stages": names,
            "planes_crossed": planes,
            "files": sorted({s["_file"] for s in stage_records if s and "_file" in s}),
            # The acceptance contract: at least one client-side span, the
            # flush, the swap and the first served batch all resolved, and
            # the whole chain shares the flush's single trace id.
            "complete": bool(
                upstream
                and swap is not None
                and batch is not None
                and len(core_traces) == 1
                and upstream_same
            ),
        }
        chains.append(chain)

    traces = sorted({r.get("trace") for r in records if r.get("trace")})
    complete = [c for c in chains if c["complete"]]
    return {
        "records": len(records),
        "files": sorted({r["_file"] for r in records}),
        "traces": len(traces),
        "chains": chains,
        "n_chains": len(chains),
        "n_complete": len(complete),
        "complete": bool(complete),
        "best": max(
            chains,
            key=lambda c: (c["complete"], len(c["planes_crossed"]), len(c["stages"])),
            default=None,
        ),
    }


def stitch_files(paths: Iterable[str]) -> dict:
    return stitch(load_records(paths))


def summarize(stitched: dict) -> dict:
    """The compact summary the command line prints."""
    best = stitched.get("best") or {}
    return {
        "records": stitched["records"],
        "traces": stitched["traces"],
        "chains": stitched["n_chains"],
        "n_complete": stitched["n_complete"],
        "complete": stitched["complete"],
        "trace": best.get("trace"),
        "planes_crossed": best.get("planes_crossed", []),
        "stages": best.get("stages", []),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m fedcrack_tpu_torch.tools.trace_stitch", description=__doc__
    )
    p.add_argument("paths", nargs="+", help="span JSONL files (one per process)")
    p.add_argument(
        "--trace", default="", help="only report chains on this trace id"
    )
    p.add_argument(
        "--require",
        default="",
        help="comma-separated span names the best chain must contain "
        "(exit 1 otherwise); default: require one complete chain",
    )
    p.add_argument("--json", default="", help="write the full stitched result here")
    args = p.parse_args(argv)
    stitched = stitch_files(args.paths)
    if args.trace:
        stitched["chains"] = [
            c for c in stitched["chains"] if c["trace"] == args.trace
        ]
        stitched["n_chains"] = len(stitched["chains"])
        stitched["n_complete"] = sum(c["complete"] for c in stitched["chains"])
        stitched["complete"] = stitched["n_complete"] > 0
        stitched["best"] = max(
            stitched["chains"],
            key=lambda c: (c["complete"], len(c["planes_crossed"])),
            default=None,
        )
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(stitched, f, indent=1, sort_keys=True, default=str)
    summary = summarize(stitched)
    print(json.dumps(summary, indent=1, sort_keys=True))
    if args.require:
        wanted = [s for s in args.require.split(",") if s]
        missing = [s for s in wanted if s not in summary["stages"]]
        if missing:
            print(f"incomplete chain: missing {missing}", file=sys.stderr)
            return 1
        return 0
    return 0 if summary["complete"] else 1


if __name__ == "__main__":
    sys.exit(main())
