"""The fedlint core (the counterpart of ``fedcrack_tpu.analysis.engine``,
with its version and baseline format, so one reader takes both packages'
baselines): module loading, the finding/severity model, per-line
suppressions, the checked-in baseline, and the per-file result cache.

Rules are small objects (see ``rules/``) with an ``id``, a ``severity`` and
a ``check(module) -> findings`` method; project-scope rules (the lock-order
graph) additionally see every module at once via ``check_project``. The
engine parses each file exactly once into a :class:`ModuleSource` (AST +
source lines + a parent map) and hands that to every rule, so adding a rule
costs one AST walk, not one parse.

Suppressions: a ``# fedlint: disable=RULE[,RULE...]`` comment suppresses
matching findings on its own line, or — when the comment is the whole line —
on the next line. ``disable=all`` suppresses every rule. A file-wide
``# fedlint: disable-file=RULE`` anywhere in the file suppresses the rule
for the entire file. Suppressions are for findings with a *reason*; put the
reason after ``--`` in the comment.

Baseline: a JSON file of fingerprinted findings accepted as-is. The
fingerprint hashes (rule, path, stripped source line) — NOT the line
number — so re-indenting or moving code keeps the baseline valid, while
*changing* the offending line invalidates it and resurfaces the finding.
"""

from __future__ import annotations

import ast
import dataclasses
import enum
import hashlib
import json
import os
import tokenize
from typing import Any, Iterable, Sequence

ENGINE_VERSION = 1

# Generated modules are not ours to lint: file-name suffixes, and whole
# directories by name (``_build/`` holds the compiled native libraries).
DEFAULT_EXCLUDES = ("_pb2.py", "_build")


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    severity: Severity
    path: str          # repo-relative, '/'-separated
    line: int          # 1-based
    col: int           # 0-based
    message: str
    source_line: str = ""

    def fingerprint(self) -> str:
        """Stable identity for baseline matching: rule + path + the stripped
        offending line (line numbers drift; the code itself is the claim)."""
        key = f"{self.rule}:{self.path}:{self.source_line.strip()}"
        return hashlib.sha256(key.encode()).hexdigest()[:16]

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity.name,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "source_line": self.source_line,
            "fingerprint": self.fingerprint(),
        }

    @classmethod
    def from_json(cls, d: dict) -> "Finding":
        return cls(
            rule=d["rule"],
            severity=Severity[d["severity"]],
            path=d["path"],
            line=int(d["line"]),
            col=int(d["col"]),
            message=d["message"],
            source_line=d.get("source_line", ""),
        )

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class ModuleSource:
    """One parsed module: AST, raw lines, and lazy derived views shared by
    every rule (parent map, per-line suppressions)."""

    def __init__(self, path: str, source: str):
        self.path = path.replace(os.sep, "/")
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self._parents: dict[ast.AST, ast.AST] | None = None
        self._suppressed: dict[int, set[str]] | None = None
        self._file_suppressed: set[str] | None = None

    # -- derived views --

    def parent_map(self) -> dict[ast.AST, ast.AST]:
        if self._parents is None:
            parents: dict[ast.AST, ast.AST] = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    parents[child] = node
            self._parents = parents
        return self._parents

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        parents = self.parent_map()
        while node in parents:
            node = parents[node]
            yield node

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    # -- suppressions --

    def _scan_suppressions(self) -> None:
        per_line: dict[int, set[str]] = {}
        file_wide: set[str] = set()
        try:
            tokens = tokenize.generate_tokens(iter(self.lines_for_tokenize()).__next__)
            comments = [
                (t.start[0], t.string) for t in tokens if t.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError):
            # Unparseable token stream (the AST parsed, so this is rare);
            # fall back to a per-line textual scan.
            comments = [
                (i + 1, line[line.index("#"):])
                for i, line in enumerate(self.lines)
                if "#" in line
            ]
        for lineno, text in comments:
            body = text.lstrip("#").strip()
            if not body.startswith("fedlint:"):
                continue
            directive = body[len("fedlint:"):].strip()
            for clause in directive.split(";"):
                clause = clause.strip()
                if clause.startswith("disable-file="):
                    rules = clause[len("disable-file="):]
                    file_wide.update(self._parse_rules(rules))
                elif clause.startswith("disable="):
                    rules = clause[len("disable="):]
                    parsed = self._parse_rules(rules)
                    stripped = self.line_text(lineno).strip()
                    target = lineno
                    if stripped.startswith("#"):
                        target = lineno + 1  # standalone comment guards the next line
                    per_line.setdefault(target, set()).update(parsed)
        self._suppressed = per_line
        self._file_suppressed = file_wide

    def lines_for_tokenize(self) -> list[str]:
        return [line + "\n" for line in self.lines]

    @staticmethod
    def _parse_rules(spec: str) -> set[str]:
        # "DET001,DET002 -- reason text" -> {"DET001", "DET002"}
        spec = spec.split("--")[0]
        return {r.strip() for r in spec.split(",") if r.strip()}

    def is_suppressed(self, finding: Finding) -> bool:
        if self._suppressed is None:
            self._scan_suppressions()
        assert self._suppressed is not None and self._file_suppressed is not None
        if {"all", finding.rule} & self._file_suppressed:
            return True
        rules = self._suppressed.get(finding.line, ())
        return "all" in rules or finding.rule in rules


class Rule:
    """Base rule. Subclasses set ``id``/``severity``/``description`` and
    implement ``check`` (per module) or ``check_project`` (all modules).

    ``paths``: optional path-fragment filter — the rule only sees modules
    whose repo-relative path contains one of the fragments (e.g. the
    ordered-iteration rule is scoped to ``fed/``, ``ckpt/``, ``serve/``
    where iteration order feeds serialization/aggregation).
    """

    id: str = ""
    severity: Severity = Severity.ERROR
    description: str = ""
    paths: tuple[str, ...] = ()   # empty = every module
    project_scope: bool = False   # True -> check_project(modules) once

    def applies_to(self, path: str) -> bool:
        if not self.paths:
            return True
        p = "/" + path.replace(os.sep, "/")
        return any(frag in p for frag in self.paths)

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        return ()

    def check_project(self, modules: Sequence[ModuleSource]) -> Iterable[Finding]:
        return ()

    def finding(
        self, module: ModuleSource, node: ast.AST, message: str
    ) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=self.id,
            severity=self.severity,
            path=module.path,
            line=line,
            col=getattr(node, "col_offset", 0),
            message=message,
            source_line=module.line_text(line),
        )


# ---- baseline ----


def make_baseline(findings: Iterable[Finding]) -> dict:
    """Baseline payload for a set of findings: fingerprint -> count (the
    same line can legitimately fire twice, e.g. two calls on one line)."""
    entries: dict[str, dict] = {}
    for f in findings:
        fp = f.fingerprint()
        e = entries.setdefault(
            fp, {"rule": f.rule, "path": f.path, "line": f.source_line.strip(),
                 "count": 0}
        )
        e["count"] += 1
    return {"version": ENGINE_VERSION, "entries": entries}


def load_baseline(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    if payload.get("version") != ENGINE_VERSION:
        raise ValueError(f"unknown baseline version {payload.get('version')!r}")
    return payload


def apply_baseline(findings: list[Finding], baseline: dict) -> list[Finding]:
    """Drop findings covered by the baseline, count-limited per fingerprint
    (so a NEW duplicate of a baselined line still surfaces)."""
    budget = {fp: e["count"] for fp, e in baseline.get("entries", {}).items()}
    out = []
    for f in findings:
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            continue
        out.append(f)
    return out


# ---- engine ----


class LintEngine:
    """Loads modules, runs rules, applies suppressions + baseline.

    ``cache_dir``: optional per-file findings cache (keyed on path + mtime +
    size + the rule-set version) — per-module rules only; project-scope
    rules always run, their inputs are cross-file.
    """

    def __init__(
        self,
        rules: Sequence[Rule] | None = None,
        cache_dir: str | None = None,
    ):
        if rules is None:
            from fedcrack_tpu_torch.analysis.rules import all_rules

            rules = all_rules()
        self.rules = list(rules)
        self.cache_dir = cache_dir
        self._cache: dict[str, Any] | None = None

    # -- module loading --

    @staticmethod
    def iter_python_files(
        root: str, excludes: Sequence[str] = DEFAULT_EXCLUDES
    ) -> list[str]:
        if os.path.isfile(root):
            return [root]
        out = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames
                if d != "__pycache__" and not d.startswith(".") and d not in excludes
            )
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                if any(name.endswith(ex) for ex in excludes):
                    continue
                out.append(os.path.join(dirpath, name))
        return out

    def load_modules(
        self, paths: Sequence[str], rel_to: str | None = None
    ) -> list[ModuleSource]:
        modules = []
        for root in paths:
            for fp in self.iter_python_files(root):
                rel = os.path.relpath(fp, rel_to) if rel_to else fp
                with open(fp, encoding="utf-8") as f:
                    modules.append(ModuleSource(rel, f.read()))
        return modules

    # -- cache --

    def _cache_key(self) -> str:
        return f"v{ENGINE_VERSION}:" + ",".join(sorted(r.id for r in self.rules))

    def _cache_path(self) -> str:
        assert self.cache_dir is not None
        return os.path.join(self.cache_dir, "cache.json")

    def _load_cache(self) -> dict:
        if self._cache is None:
            self._cache = {}
            if self.cache_dir is not None:
                try:
                    with open(self._cache_path(), encoding="utf-8") as f:
                        payload = json.load(f)
                    if payload.get("key") == self._cache_key():
                        self._cache = payload.get("files", {})
                except (OSError, ValueError):
                    pass
        return self._cache

    def _save_cache(self) -> None:
        if self.cache_dir is None or self._cache is None:
            return
        os.makedirs(self.cache_dir, exist_ok=True)
        with open(self._cache_path(), "w", encoding="utf-8") as f:
            json.dump({"key": self._cache_key(), "files": self._cache}, f)

    @staticmethod
    def _stat_sig(path: str) -> list[int] | None:
        try:
            st = os.stat(path)
        except OSError:
            return None
        return [int(st.st_mtime_ns), st.st_size]

    # -- running --

    def lint_source(self, source: str, path: str = "<memory>") -> list[Finding]:
        """Lint one in-memory module (the fixture-test entry point).
        Per-module rules only; suppressions applied, no baseline."""
        module = ModuleSource(path, source)
        findings: list[Finding] = []
        for rule in self.rules:
            if rule.project_scope or not rule.applies_to(module.path):
                continue
            findings.extend(rule.check(module))
        findings = [f for f in findings if not module.is_suppressed(f)]
        return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))

    def lint_modules(
        self,
        modules: Sequence[ModuleSource],
        abs_paths: dict[str, str] | None = None,
    ) -> list[Finding]:
        """Run every rule over ``modules``; suppressions applied, no
        baseline. ``abs_paths`` (module path -> filesystem path) enables the
        cache for per-module rules."""
        cache = self._load_cache() if self.cache_dir is not None else None
        findings: list[Finding] = []
        by_path = {m.path: m for m in modules}
        for module in modules:
            sig = None
            if cache is not None and abs_paths and module.path in abs_paths:
                sig = self._stat_sig(abs_paths[module.path])
                entry = cache.get(module.path)
                if sig is not None and entry is not None and entry["sig"] == sig:
                    findings.extend(
                        Finding.from_json(d) for d in entry["findings"]
                    )
                    continue
            mod_findings: list[Finding] = []
            for rule in self.rules:
                if rule.project_scope or not rule.applies_to(module.path):
                    continue
                mod_findings.extend(rule.check(module))
            mod_findings = [
                f for f in mod_findings if not by_path[f.path].is_suppressed(f)
            ]
            if cache is not None and sig is not None:
                cache[module.path] = {
                    "sig": sig,
                    "findings": [f.to_json() for f in mod_findings],
                }
            findings.extend(mod_findings)
        for rule in self.rules:
            if not rule.project_scope:
                continue
            scoped = [m for m in modules if rule.applies_to(m.path)]
            for f in rule.check_project(scoped):
                owner = by_path.get(f.path)
                if owner is None or not owner.is_suppressed(f):
                    findings.append(f)
        if cache is not None:
            self._save_cache()
        return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))

    def lint_paths(
        self,
        paths: Sequence[str],
        rel_to: str | None = None,
        baseline: dict | None = None,
    ) -> list[Finding]:
        abs_paths = {}
        for root in paths:
            for fp in self.iter_python_files(root):
                rel = os.path.relpath(fp, rel_to) if rel_to else fp
                abs_paths[rel.replace(os.sep, "/")] = fp
        modules = self.load_modules(paths, rel_to=rel_to)
        findings = self.lint_modules(modules, abs_paths=abs_paths)
        if baseline is not None:
            findings = apply_baseline(findings, baseline)
        return findings
