"""fedlint CLI — run the port's static-analysis rule packs over
``fedcrack_tpu_torch/`` (the counterpart of ``fedcrack_tpu.tools.fedlint``).

Usage (from the repo root)::

    python -m fedcrack_tpu_torch.tools.fedlint                  # whole package
    python -m fedcrack_tpu_torch.tools.fedlint fedcrack_tpu_torch/serve
    python -m fedcrack_tpu_torch.tools.fedlint --rules DET001,DUR001
    python -m fedcrack_tpu_torch.tools.fedlint --json findings.json
    python -m fedcrack_tpu_torch.tools.fedlint --lock-graph fedcrack_tpu_torch/analysis/serve_lock_graph.json
    python -m fedcrack_tpu_torch.tools.fedlint --write-baseline fedlint_torch_baseline.json

Exit codes (CI contract): 0 = clean, 1 = non-baselined findings, 2 = usage
or internal error. The committed ``fedlint_torch_baseline.json`` at the
repo root is applied automatically when present (``--no-baseline`` to see
everything); the tier-1 gate test pins "zero non-baselined findings over
fedcrack_tpu_torch/".

The per-file result cache lives in ``.fedlint_cache/`` (gitignored); it is
keyed on file mtime+size and the rule-set version, so ``--no-cache`` is only
needed when hacking on the rules themselves.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from fedcrack_tpu_torch.analysis.engine import (
    LintEngine,
    ModuleSource,
    Severity,
    apply_baseline,
    load_baseline,
    make_baseline,
)
from fedcrack_tpu_torch.analysis.rules import all_rules, rules_by_id
from fedcrack_tpu_torch.analysis.rules.locks import build_lock_graph

DEFAULT_BASELINE = "fedlint_torch_baseline.json"
DEFAULT_CACHE_DIR = ".fedlint_cache"


def repo_root() -> str:
    """The directory holding the fedcrack_tpu_torch package."""
    import fedcrack_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(fedcrack_tpu_torch.__file__)))


def _parse_args(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="fedlint", description="repo-native static analysis"
    )
    p.add_argument("paths", nargs="*", help="files/dirs to lint "
                   "(default: the fedcrack_tpu_torch package)")
    p.add_argument("--rules", help="comma-separated rule ids to run "
                   "(default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: {DEFAULT_BASELINE} at the "
                   "repo root when present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--write-baseline", metavar="PATH",
                   help="write the current findings as the new baseline and "
                   "exit 0")
    p.add_argument("--json", metavar="PATH",
                   help="also write findings as JSON ('-' for stdout)")
    p.add_argument("--lock-graph", metavar="PATH",
                   help="emit the static lock-acquisition graph (nodes/"
                   "edges/cycles) as JSON and continue")
    p.add_argument("--cache-dir", default=None,
                   help=f"per-file cache dir (default: {DEFAULT_CACHE_DIR} "
                   "at the repo root)")
    p.add_argument("--no-cache", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    try:
        args = _parse_args(argv)
    except SystemExit as e:
        return 0 if e.code in (0, None) else 2

    if args.list_rules:
        for rule in all_rules():
            scope = ",".join(rule.paths) if rule.paths else "all files"
            print(f"{rule.id:9s} {rule.severity.name:7s} [{scope}]")
            print(f"          {rule.description}")
        return 0

    root = repo_root()
    rules = all_rules()
    if args.rules:
        catalog = rules_by_id()
        wanted = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in wanted if r not in catalog]
        if unknown:
            print(f"fedlint: unknown rule ids: {', '.join(unknown)} "
                  f"(--list-rules for the catalog)", file=sys.stderr)
            return 2
        rules = [catalog[r] for r in wanted]

    paths = args.paths or [os.path.join(root, "fedcrack_tpu_torch")]
    for pth in paths:
        if not os.path.exists(pth):
            print(f"fedlint: no such path: {pth}", file=sys.stderr)
            return 2

    cache_dir = None
    if not args.no_cache:
        cache_dir = args.cache_dir or os.path.join(root, DEFAULT_CACHE_DIR)
    engine = LintEngine(rules, cache_dir=cache_dir)

    # One walk serves both the modules and the cache's path mapping.
    abs_paths: dict[str, str] = {}
    for pth in paths:
        for fp in engine.iter_python_files(pth):
            rel = os.path.relpath(fp, root).replace(os.sep, "/")
            abs_paths[rel] = fp
    modules = []
    try:
        for rel, fp in abs_paths.items():
            with open(fp, encoding="utf-8") as f:
                modules.append(ModuleSource(rel, f.read()))
    except SyntaxError as e:
        print(f"fedlint: cannot parse {e.filename}:{e.lineno}: {e.msg}",
              file=sys.stderr)
        return 2

    # With --json - the payload owns stdout; human-readable lines move to
    # stderr so the JSON can be piped straight into a parser.
    report = sys.stderr if args.json == "-" else sys.stdout

    if args.lock_graph:
        graph = build_lock_graph(
            [m for m in modules
             if any(r.id == "LOCK001" and r.applies_to(m.path) for r in rules)
             or not any(r.id == "LOCK001" for r in rules)]
        )
        payload = graph.to_json()
        os.makedirs(os.path.dirname(os.path.abspath(args.lock_graph)),
                    exist_ok=True)
        with open(args.lock_graph, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"fedlint: lock graph ({len(payload['nodes'])} locks, "
              f"{len(payload['edges'])} edges, {len(payload['cycles'])} "
              f"cycles) -> {args.lock_graph}", file=report)

    findings = engine.lint_modules(modules, abs_paths=abs_paths)

    if args.write_baseline:
        payload = make_baseline(findings)
        with open(args.write_baseline, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"fedlint: baselined {len(findings)} findings "
              f"({len(payload['entries'])} fingerprints) -> "
              f"{args.write_baseline}")
        return 0

    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline:
        candidate = os.path.join(root, DEFAULT_BASELINE)
        baseline_path = candidate if os.path.exists(candidate) else None
    if baseline_path and not args.no_baseline:
        try:
            findings = apply_baseline(findings, load_baseline(baseline_path))
        except (OSError, ValueError) as e:
            print(f"fedlint: bad baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2

    if args.json:
        payload = {"version": 1, "findings": [f.to_json() for f in findings]}
        if args.json == "-":
            json.dump(payload, sys.stdout, indent=2, sort_keys=True)
            print()
        else:
            with open(args.json, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.write("\n")

    for f in findings:
        print(f, file=report)
    n_err = sum(1 for f in findings if f.severity >= Severity.ERROR)
    if findings:
        print(f"fedlint: {len(findings)} finding(s) ({n_err} error(s))",
              file=report)
        return 1
    print("fedlint: clean", file=report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
