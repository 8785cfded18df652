"""The port's edge relay (``transport/edge.py``) held against the JAX
package's on the CPU, over loopback gRPC.

- Mixed peers: a two-edge root round where each edge pushes its partial
  through an ``EdgeRelay``, for every pairing of the relays' packages
  with the root ``FedServer``'s package. The handshake, each reply's
  status, the root's round history and its new global are equal in
  every pairing, and the global is the exact weighted mean.
- The client -> edge -> root trace of tests/test_tracing.py, run once
  wholly in each package (clients, edge, relay, root, span recorder and
  ``tools/trace_stitch``): the two stitched chains have the same shape.
"""

import dataclasses
import threading
import types

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

JOIN_S = 30


def _vars(value: float):
    return {"params": {"w": np.full((4, 4), value, np.float32)}}


def _package(name: str):
    if name == "jax":
        from fedcrack_tpu.configs import FedConfig
        from fedcrack_tpu.fed import rounds as R
        from fedcrack_tpu.fed import serialization as ser
        from fedcrack_tpu.fed.tree import EdgeAggregator
        from fedcrack_tpu.obs import spans as tracing
        from fedcrack_tpu.tools.trace_stitch import stitch_files
        from fedcrack_tpu.transport import FedClient, FedServer
        from fedcrack_tpu.transport.edge import EdgeRelay
        from fedcrack_tpu.transport.service import ServerThread
    else:
        from fedcrack_tpu_torch.configs import FedConfig
        from fedcrack_tpu_torch.fed import rounds as R
        from fedcrack_tpu_torch.fed import serialization as ser
        from fedcrack_tpu_torch.fed.tree import EdgeAggregator
        from fedcrack_tpu_torch.obs import spans as tracing
        from fedcrack_tpu_torch.tools.trace_stitch import stitch_files
        from fedcrack_tpu_torch.transport import FedClient, FedServer
        from fedcrack_tpu_torch.transport.edge import EdgeRelay
        from fedcrack_tpu_torch.transport.service import ServerThread
    return types.SimpleNamespace(
        name=name, FedConfig=FedConfig, R=R, ser=ser, EdgeAggregator=EdgeAggregator, tracing=tracing,
        stitch_files=stitch_files, FedClient=FedClient, FedServer=FedServer, EdgeRelay=EdgeRelay,
        ServerThread=ServerThread,
    )


# Two edges of leaves (name, value, samples).
SHARDS = {"edge-0": [("a", 1.0, 10), ("b", 2.0, 10), ("c", 6.0, 20)], "edge-1": [("d", 8.0, 40)]}


def _root_round(server: str, relays: dict) -> dict:
    """One root round over gRPC: the root of package ``server``; edge
    ``e`` aggregates its shard with package ``relays[e]``'s
    ``EdgeAggregator`` and pushes through that package's relay."""
    S = _package(server)
    cfg = S.FedConfig(max_rounds=2, cohort_size=2, registration_window_s=5.0, round_deadline_s=60.0, port=0)
    root = S.FedServer(cfg, _vars(0.0), tick_period_s=0.02)
    out = {"handshakes": [], "replies": []}
    with S.ServerThread(root) as st:
        pkgs = {e: _package(relays[e]) for e in SHARDS}
        live = {e: P.EdgeRelay(e, st.port) for e, P in pkgs.items()}
        try:
            for e, relay in live.items():
                out["handshakes"].append(relay.enroll())
            base = live["edge-0"].pull()
            assert base == live["edge-1"].pull() == root.state.broadcast_blob
            rnd = int(out["handshakes"][0]["current_round"])
            version = int(out["handshakes"][0]["model_version"])
            for e, relay in live.items():
                P = pkgs[e]
                edge = P.EdgeAggregator(e, P.ser.tree_from_bytes(base))
                edge.begin_round(rnd, base, version, [leaf for leaf, _, _ in SHARDS[e]])
                for leaf, value, ns in SHARDS[e]:
                    assert edge.offer(leaf, P.ser.tree_to_bytes(_vars(value)), ns)[0]
                partial, total = edge.partial()
                status, weights, config = relay.push_partial(rnd, partial, total, trace_ctx=edge.last_partial_ctx)
                out["replies"].append((status, config))
                if e == "edge-0":
                    out["poll_before_close"] = relay.poll(version, rnd)[0]
                else:
                    out["global"] = weights
            out["poll_after_close"] = live["edge-0"].poll(version, rnd)[:2]
        finally:
            for relay in live.values():
                relay.close()
        state = st.state
    out["history"] = [{k: h[k] for k in ("round", "clients", "samples", "rejected")} for h in state.history]
    return out


PAIRINGS = [("port", {"edge-0": "port", "edge-1": "port"}), ("jax", {"edge-0": "port", "edge-1": "port"}),
            ("port", {"edge-0": "jax", "edge-1": "jax"}), ("jax", {"edge-0": "jax", "edge-1": "port"}),
            ("port", {"edge-0": "port", "edge-1": "jax"})]


@pytest.fixture(scope="module")
def jax_round():
    """The all-JAX round, checked against its closed form."""
    from fedcrack_tpu_torch.fed import rounds as R
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes

    want = _root_round("jax", {"edge-0": "jax", "edge-1": "jax"})
    # edge-0: (10 * 1 + 10 * 2 + 20 * 6) / 40 = 3.75; the root:
    # (40 * 3.75 + 40 * 8) / 80 = 5.875.
    np.testing.assert_allclose(tree_from_bytes(want["global"])["params"]["w"], 5.875, atol=1e-6)
    assert [s for s, _ in want["replies"]] == [R.RESP_ACY, R.RESP_ARY]
    assert want["poll_before_close"] == R.WAIT
    assert want["poll_after_close"] == (R.NOT_WAIT, want["global"])
    assert want["history"] == [{"round": 1, "clients": ["edge-0", "edge-1"], "samples": [40, 40], "rejected": {}}]
    return want


@pytest.mark.parametrize("server,relays", PAIRINGS, ids=lambda v: v if isinstance(v, str) else "-".join(v.values()))
def test_relays_of_either_package_against_roots_of_either(jax_round, server, relays):
    assert _root_round(server, relays) == jax_round


def test_relay_refusal_when_the_root_turns_it_away():
    """An edge the root does not enroll (its cohort is full) raises, with
    the root's status in the message, in either package."""
    from fedcrack_tpu_torch.transport.edge import EdgeRelay

    for server in ("port", "jax"):
        S = _package(server)
        cfg = S.FedConfig(max_rounds=1, cohort_size=1, registration_window_s=5.0, port=0)
        with S.ServerThread(S.FedServer(cfg, _vars(0.0), tick_period_s=0.02)) as st:
            with EdgeRelay("edge-0", st.port) as first, EdgeRelay("edge-1", st.port) as late:
                first.enroll()
                with pytest.raises(RuntimeError, match="edge edge-1 not enrolled at root: CTW"):
                    late.enroll()


def _trainer(P, delta: float):
    def train(blob, rnd):
        tree = P.ser.tree_from_bytes(blob)
        tree["params"]["w"] = tree["params"]["w"] + delta
        return P.ser.tree_to_bytes(tree), 4, {"loss": float(rnd)}

    return train


def _traced_session(name: str, spans_path) -> dict:
    """tests/test_tracing.py's client -> edge -> root session in package
    ``name``; returns the stitched chain."""
    P = _package(name)
    P.tracing.install(spans_path)
    cfg = P.FedConfig(max_rounds=1, cohort_size=3, registration_window_s=5.0, round_deadline_s=30.0,
                      poll_period_s=0.05, port=0)
    server = P.FedServer(cfg, _vars(0.0), tick_period_s=0.05)
    results = {}
    try:
        with P.ServerThread(server) as st:
            cfg_port = dataclasses.replace(cfg, port=st.port)
            clients = [P.FedClient(cfg_port, _trainer(P, 0.1), cname="c0"),
                       P.FedClient(cfg_port, _trainer(P, 0.2), cname="c1")]
            threads = [threading.Thread(target=lambda c=c: results.update({c.cname: c.run_session()}), daemon=True)
                       for c in clients]
            for t in threads:
                t.start()
            with P.EdgeRelay("edge-0", st.port) as relay:
                handshake = relay.enroll()
                base = relay.pull()
                edge = P.EdgeAggregator("edge-0", server.state.template)
                edge.begin_round(int(handshake["current_round"]), base, int(handshake["model_version"]),
                                 ["leaf-0", "leaf-1"])
                for i, leaf in enumerate(("leaf-0", "leaf-1")):
                    ctx = P.tracing.TraceContext(P.tracing.version_trace(edge.base_version), f"train:{leaf}:r1")
                    with P.tracing.span("client.train", trace=ctx.trace, cname=leaf, ctx=ctx.to_wire()):
                        blob = P.ser.tree_to_bytes(_vars(0.3 + i / 10))
                    ok, why = edge.offer(leaf, blob, 4, trace_ctx=ctx.to_wire())
                    assert ok, why
                partial, total = edge.partial()
                assert edge.last_partial_ctx.startswith("fedtr-v0#edge:edge-0:")
                status, _weights, _cfg = relay.push_partial(1, partial, total, trace_ctx=edge.last_partial_ctx)
                assert status in (P.R.RESP_ACY, P.R.RESP_ARY, P.R.FIN)
            for t in threads:
                t.join(timeout=JOIN_S)
                assert not t.is_alive(), "client session hung"
    finally:
        P.tracing.uninstall()
    assert results["c0"].rounds_completed == 1
    stitched = P.stitch_files([str(spans_path)])
    assert stitched["n_chains"] == 1
    return stitched["chains"][0]


def _shape(chain: dict) -> dict:
    by_name = {}
    for u in chain["upstream"]:
        by_name.setdefault(u["span"]["name"], []).append(u)
    return {
        "trace": chain["trace"],
        "version": chain["version"],
        "upstream": sorted((n, len(v)) for n, v in by_name.items()),
        "edge_leaves": [[leaf["name"] for leaf in u["leaves"]] for u in by_name.get("edge.flush_partial", [])],
        "push_trains": sorted(u["train"]["name"] for u in by_name.get("client.push", []) if u["train"]),
        "unresolved_links": chain["unresolved_links"],
        "planes_crossed": sorted(chain["planes_crossed"]),
        "complete": chain["complete"],
    }


def test_trace_propagates_client_edge_root_like_jax(tmp_path):
    got = _shape(_traced_session("port", tmp_path / "port.jsonl"))
    want = _shape(_traced_session("jax", tmp_path / "jax.jsonl"))
    assert got == want
    assert got["trace"] == "fedtr-v0" and got["version"] == 1
    assert got["upstream"] == [("client.push", 2), ("edge.flush_partial", 1)]
    assert got["edge_leaves"] == [["client.train", "client.train"]]
    assert got["push_trains"] == ["client.train", "client.train"]
    assert got["unresolved_links"] == []
    assert {"client", "edge", "fed"} <= set(got["planes_crossed"]) and not got["complete"]


@pytest.mark.parametrize("server", ["port", "jax"])
def test_relay_carries_a_blob_over_grpcs_default_cap(server):
    """A full-width model's blob (8.2 MB at ``ModelConfig()``) is over
    grpc's 4 MiB default receive cap. The port's relay opens its channel
    at ``FedConfig``'s default ``max_message_mb``, so it pulls such a base and
    pushes such a partial to a root of either package; the JAX package's
    relay, on grpc's default, cannot pull it."""
    import grpc

    from fedcrack_tpu.transport.edge import EdgeRelay as JaxRelay
    from fedcrack_tpu_torch.fed.serialization import tree_from_bytes, tree_to_bytes
    from fedcrack_tpu_torch.fed.tree import EdgeAggregator
    from fedcrack_tpu_torch.transport.edge import EdgeRelay

    def big(value):
        return {"params": {"w": np.full((1200, 1200), value, np.float32)}}

    S = _package(server)
    cfg = S.FedConfig(max_rounds=1, cohort_size=1, registration_window_s=5.0, round_deadline_s=60.0, port=0)
    with S.ServerThread(S.FedServer(cfg, big(0.0), tick_period_s=0.02)) as st:
        with JaxRelay("edge-j", st.port) as jax_relay:
            with pytest.raises(grpc.RpcError, match="RESOURCE_EXHAUSTED|larger than max"):
                jax_relay.pull()
        with EdgeRelay("edge-0", st.port) as relay:
            hello = relay.enroll()
            base = relay.pull()
            assert len(base) > 4 * 1024 * 1024
            edge = EdgeAggregator("edge-0", tree_from_bytes(base))
            edge.begin_round(int(hello["current_round"]), base, int(hello["model_version"]), ["a"])
            assert edge.offer("a", tree_to_bytes(big(2.0)), 5)[0]
            status, weights, _ = relay.push_partial(int(hello["current_round"]), *edge.partial())
    assert status == S.R.FIN
    np.testing.assert_array_equal(tree_from_bytes(weights)["params"]["w"], 2.0)
