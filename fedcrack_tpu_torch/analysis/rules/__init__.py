"""fedlint rule registry (the counterpart of ``fedcrack_tpu.analysis.rules``:
the same packs, ids and order; KERN001 and TRACE001 match the port's idioms).

Each rule pack module exports ``RULES``; ``all_rules()`` instantiates the
full set in a stable order. ``rules_by_id`` powers the CLI's ``--rules``
filter and ``--list-rules``.
"""

from __future__ import annotations

from fedcrack_tpu_torch.analysis.engine import Rule


def all_rules() -> list[Rule]:
    from fedcrack_tpu_torch.analysis.rules import (
        agg_plane,
        async_plane,
        compress,
        deadcode,
        determinism,
        durability,
        fleet_plane,
        health_plane,
        kernel_plane,
        locks,
        obs_plane,
        privacy_plane,
        serve_plane,
        trace,
        transport,
    )

    out: list[Rule] = []
    for pack in (
        determinism, durability, trace, transport, compress, async_plane,
        obs_plane, health_plane, agg_plane, locks, deadcode, serve_plane,
        kernel_plane, fleet_plane, privacy_plane,
    ):
        out.extend(cls() for cls in pack.RULES)
    return out


def rules_by_id() -> dict[str, Rule]:
    return {r.id: r for r in all_rules()}
