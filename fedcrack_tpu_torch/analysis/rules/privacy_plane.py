"""Privacy-plane rule pack (round 23).

- **PRIV001 unseeded randomness in the privacy plane**: inside
  ``privacy/`` every random draw must trace to an EXPLICIT seed. The
  package's whole contract is that masks and noise are replayable — a
  chaos-retried round reproduces bit-identical DP noise, a restarted
  server reconstructs a dropped masker's pads from its enroll-time seed,
  and the secagg drill pins the unmasked average bit-for-bit. One
  ambient-entropy draw (``default_rng()`` with no seed, ``os.urandom``,
  ``uuid4``, a wall-clock fed into a key) silently breaks all three: the
  retry double-noises, the recovery subtracts the WRONG pad (corrupting
  the global, not just a metric), and nothing fails loudly because the
  bytes are still well-formed.

  DET002 already flags module-level ``random.*``/``np.random.*`` draws
  repo-wide; PRIV001 tightens the net where it matters most — argless
  generator CONSTRUCTION (``default_rng()``, ``Philox()``,
  ``random.Random()``: seeded-looking, OS-entropy-backed) and
  nondeterministic entropy sources (``os.urandom``, ``secrets.*``,
  ``uuid.uuid1/4``, wall clocks) anywhere in ``privacy/``, severity
  ERROR, no legitimate suppression expected.
"""

from __future__ import annotations

import ast
from typing import Iterable

from fedcrack_tpu_torch.analysis.engine import Finding, ModuleSource, Rule, Severity
from fedcrack_tpu_torch.analysis.rules._ast_util import call_name

# Generator constructors that are deterministic ONLY when given a seed/key:
# called with no arguments at all they pull OS entropy — the silent
# non-reproducibility PRIV001 exists to kill.
SEEDABLE_CONSTRUCTORS = {
    "default_rng",
    "Random",
    "RandomState",
    "Philox",
    "PCG64",
    "SFC64",
    "MT19937",
    "SeedSequence",
}

# Calls that are nondeterministic entropy BY DESIGN — never acceptable in
# the privacy plane, seeded or not (there is nothing to seed).
ENTROPY_SOURCES = {
    "os.urandom",
    "secrets.token_bytes",
    "secrets.token_hex",
    "secrets.token_urlsafe",
    "secrets.randbits",
    "secrets.randbelow",
    "secrets.choice",
    "uuid.uuid1",
    "uuid.uuid4",
    "time.time",
    "time.time_ns",
    "datetime.now",
    "datetime.datetime.now",
    "datetime.utcnow",
    "datetime.datetime.utcnow",
}


class UnseededPrivacyRandomRule(Rule):
    id = "PRIV001"
    severity = Severity.ERROR
    description = (
        "unseeded/ambient randomness inside privacy/: masks and DP noise "
        "must derive from explicit seeds or replay breaks silently "
        "(double-drawn noise, wrong recovered pads)"
    )
    paths = ("privacy/",)

    def check(self, module: ModuleSource) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            if name in ENTROPY_SOURCES:
                yield self.finding(
                    module,
                    node,
                    f"{name}() is nondeterministic entropy — the privacy "
                    "plane's masks/noise must derive from explicit seeds "
                    "(sha256-rooted, like privacy.secagg.client_seed)",
                )
                continue
            tail = name.split(".")[-1]
            if (
                tail in SEEDABLE_CONSTRUCTORS
                and not node.args
                and not node.keywords
            ):
                yield self.finding(
                    module,
                    node,
                    f"{name}() constructed without a seed pulls OS entropy "
                    "— pass an explicit seed/key so masks and noise replay "
                    "bit-identically",
                )


RULES = [UnseededPrivacyRandomRule]
