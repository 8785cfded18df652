"""The port's compressed update transport (compress/, native/crc32c) held
against the JAX package's ``fedcrack_tpu.compress`` and
``fedcrack_tpu.native.crc32c`` on the CPU.

The contract is exact: for the same blobs every codec writes byte-equal
frames (three rounds, so the top-k residual and the seeded int8 streams
are exercised), ``decode_update`` reconstructs bitwise-equal trees, every
rejection carries the JAX package's reason string, and the compiled
CRC32C, its table version and the JAX package's agree on every length
from 0 to 4099.
"""

import struct

import jax
import msgpack
import numpy as np
import pytest

from fedcrack_tpu.compress import codecs as jc
from fedcrack_tpu.compress import frames as jf
from fedcrack_tpu.fed import serialization as jser
from fedcrack_tpu_torch.compress import codecs as tc
from fedcrack_tpu_torch.compress import frames as tf

pytestmark = pytest.mark.torch_port


def _small(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(6, 5)).astype(np.float32),
                       "b": rng.normal(size=(5,)).astype(np.float32)}}


def _mixed(seed):
    """Leaves on and off the QSGD bucket (16384): one entry, a 0-d leaf,
    a leaf of three buckets, a 4-d kernel, and batch statistics."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"conv": {"kernel": rng.normal(0, 0.1, (3, 3, 4, 8)).astype(np.float32),
                            "bias": rng.normal(size=(8,)).astype(np.float32)},
                   "dense": {"kernel": rng.normal(0, 0.05, (40000,)).astype(np.float32)},
                   "one": rng.normal(size=(1,)).astype(np.float32),
                   "scalar": np.asarray(rng.normal(), np.float32)},
        "batch_stats": {"bn": {"mean": rng.normal(size=(8,)).astype(np.float32),
                               "var": rng.uniform(0.5, 2, (8,)).astype(np.float32)}},
    }


TREES = {"small": _small, "mixed": _mixed}


def _trajectory(make, cast):
    """A base and three rounds of updates, each round's base the last
    round's update (as a federation's broadcasts would be)."""
    blobs = [jser.tree_to_bytes(make(s), cast_dtype=cast) for s in range(4)]
    return list(zip(blobs[:-1], blobs[1:]))


@pytest.mark.parametrize("cast", [None, "bfloat16"])
@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("codec", ["null", "int8", "topk_delta"])
def test_frames_byte_equal_over_three_rounds(codec, tree, cast):
    j = jc.get_codec(codec, client_tag="client_1", topk_fraction=0.05)
    t = tc.get_codec(codec, client_tag="client_1", topk_fraction=0.05)
    assert t.name == j.name == codec
    for rnd, (base, up) in enumerate(_trajectory(TREES[tree], cast), start=1):
        want = j.encode_update(up, base, round=rnd, base_version=rnd - 1)
        got = t.encode_update(up, base, round=rnd, base_version=rnd - 1)
        assert got == want, rnd
        assert tf.is_frame(got) == (codec != "null")
        if codec == "topk_delta":
            assert t.residual_mass() == j.residual_mass()
    if codec == "topk_delta":
        # A refused upload's mass comes back into the residual.
        j.rollback_last()
        t.rollback_last()
        assert t.residual_mass() == j.residual_mass() > 0
        base, up = _trajectory(TREES[tree], cast)[0]
        assert t.encode_update(up, base, round=9, base_version=9) == \
            j.encode_update(up, base, round=9, base_version=9)


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("codec", ["int8", "topk_delta"])
def test_decode_update_reconstructs_bitwise(codec, tree):
    make = TREES[tree]
    base_tree, up = make(0), make(1)
    base = jser.tree_to_bytes(base_tree)
    frame = jc.get_codec(codec, topk_fraction=0.1).encode_update(jser.tree_to_bytes(up), base, round=2,
                                                                 base_version=3)
    want, jframe = jf.decode_update(frame, template=base_tree, base=base_tree, expected_base_version=3,
                                    expected_round=2)
    got, tframe = tf.decode_update(frame, template=base_tree, base=base_tree, expected_base_version=3,
                                   expected_round=2)
    assert (tframe.codec, tframe.round, tframe.base_version, tframe.leaves, tframe.payload) == \
        (jframe.codec, jframe.round, jframe.base_version, jframe.leaves, jframe.payload)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == np.asarray(b).tobytes()


def _crc_frame(body_map):
    from fedcrack_tpu.native import crc32c

    body = msgpack.packb(body_map, use_bin_type=True)
    return b"FCWF" + struct.pack("<I", crc32c(body)) + body


def _w(n=4):
    return {"w": np.zeros(n, np.float32)}


def _good_frame():
    base = _small(0)
    frame = jc.get_codec("int8").encode_update(jser.tree_to_bytes(_small(1)), jser.tree_to_bytes(base),
                                               round=1, base_version=4)
    return frame, base


def _flip(pos, bit):
    frame, base = _good_frame()
    pos = pos % len(frame)
    return frame[:pos] + bytes([frame[pos] ^ (1 << bit)]) + frame[pos + 1:], base, {}


REJECTIONS = {
    "bad_magic": lambda: (b"FCWX" + _good_frame()[0][4:], _good_frame()[1], {}),
    "stale_base": lambda: (*_good_frame(), {"expected_base_version": 5}),
    "wrong_round": lambda: (*_good_frame(), {"expected_round": 3}),
    "truncated_topk": lambda: (jf.encode_frame("topk_delta", 1, 0, [{"shape": [100], "enc": "topk", "k": 50}],
                                               b"\x00" * 8), {"w": np.zeros(100, np.float32)}, {}),
    "index_out_of_range": lambda: (jf.encode_frame(
        "topk_delta", 1, 0, [{"shape": [4], "enc": "topk", "k": 1}],
        np.array([9], np.int32).tobytes() + np.array([1.0], np.float32).tobytes()), _w(), {}),
    "k_outside_range": lambda: (jf.encode_frame("topk_delta", 1, 0, [{"shape": [4], "enc": "topk", "k": 5}],
                                                bytes(40), compress=False), _w(), {}),
    "lying_giant_shape": lambda: (jf.encode_frame("topk_delta", 1, 0, [{"shape": [10**12], "enc": "topk", "k": 0}],
                                                  b""), _w(), {}),
    "leaf_count_lie": lambda: (jf.encode_frame("topk_delta", 1, 0, [{"shape": [4], "enc": "topk", "k": 1}] * 2,
                                               bytes(16)), _w(), {}),
    "zlib_bomb": lambda: (jf.encode_frame("int8", 1, 0, [{"shape": [4], "enc": "int8", "scales": b"\x00" * 4,
                                                          "bucket": 4}], bytes(8 * 1024 * 1024)), _w(), {}),
    "manifest_claims_over_bound": lambda: (jf.encode_frame("topk_delta", 1, 0,
                                                           [{"shape": [4], "enc": "topk", "k": 10**9}], b""),
                                           _w(), {}),
    "inflate_fails": lambda: (_crc_frame({"v": 1, "codec": "int8", "round": 1, "base_version": 0,
                                          "leaves": [{"shape": [4], "enc": "int8"}], "zlib": True,
                                          "payload": b"junk"}), _w(), {}),
    "absurd_bucket_decodes": lambda: (jf.encode_frame(
        "int8", 1, 0, [{"shape": [4], "enc": "int8", "scales": np.array([0.5], np.float32).tobytes(),
                        "bucket": 10**12}], np.array([1, -2, 3, 0], np.int8).tobytes()), _w(), {}),
    "scales_count_lie": lambda: (jf.encode_frame(
        "int8", 1, 0, [{"shape": [4], "enc": "int8", "scales": bytes(8), "bucket": 4}], bytes(4)), _w(), {}),
    "missing_bucket": lambda: (jf.encode_frame("int8", 1, 0, [{"shape": [4], "enc": "int8"}], bytes(4)), _w(), {}),
    "unknown_encoding": lambda: (jf.encode_frame("x", 1, 0, [{"shape": [4], "enc": "fp4"}], bytes(4)), _w(), {}),
    "trailing_payload": lambda: (jf.encode_frame("int8", 1, 0, [{"shape": [4], "enc": "int8", "bucket": 4,
                                                                 "scales": bytes(4)}], bytes(6)), _w(), {}),
    "junk_round": lambda: (_crc_frame({"v": 1, "codec": "int8", "round": None, "base_version": 0, "leaves": [],
                                       "zlib": False, "payload": b""}), {}, {}),
    "junk_manifest_entries": lambda: (_crc_frame({"v": 1, "codec": "int8", "round": 1, "base_version": 0,
                                                  "leaves": [1, 2], "zlib": False, "payload": b""}), _w(), {}),
    "junk_shape": lambda: (_crc_frame({"v": 1, "codec": "int8", "round": 1, "base_version": 0,
                                       "leaves": [{"shape": "ab", "enc": "int8"}], "zlib": False,
                                       "payload": b""}), _w(), {}),
    "unknown_version": lambda: (_crc_frame({"v": 2, "leaves": [], "payload": b""}), _w(), {}),
    "not_a_map": lambda: (_crc_frame([1, 2, 3]), _w(), {}),
    "missing_payload": lambda: (_crc_frame({"v": 1, "leaves": []}), _w(), {}),
    "body_extra_data": lambda: (b"FCWF" + struct.pack("<I", jf_crc(b"\x01\x02")) + b"\x01\x02", _w(), {}),
    "body_reserved_byte": lambda: (b"FCWF" + struct.pack("<I", jf_crc(b"\xc1")) + b"\xc1", _w(), {}),
    "body_incomplete": lambda: (b"FCWF" + struct.pack("<I", jf_crc(b"\x82\xa1v")) + b"\x82\xa1v", _w(), {}),
    "body_bad_utf8": lambda: (b"FCWF" + struct.pack("<I", jf_crc(b"\xa2\xff\xfe")) + b"\xa2\xff\xfe", _w(), {}),
    **{f"bit_flip_{pos}_{bit}": (lambda p=pos, b=bit: _flip(p, b))
       for pos, bit in [(5, 0), (8, 3), (9, 7), (40, 1), (-10, 4), (-1, 0)]},
}


def jf_crc(body):
    from fedcrack_tpu.native import crc32c

    return crc32c(body)


def _outcome(decode, frame, template, kw):
    try:
        tree, _ = decode(frame, template=template, base=template, **kw)
    except ValueError as e:
        return ("error", str(e))
    return ("ok", [np.asarray(v).tobytes() for v in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_rejections_carry_the_jax_reason(case):
    frame, template, kw = REJECTIONS[case]()
    want = _outcome(jf.decode_update, frame, template, kw)
    assert _outcome(tf.decode_update, frame, template, kw) == want
    if case.startswith("bit_flip") or case in ("stale_base", "zlib_bomb", "lying_giant_shape"):
        assert want[0] == "error"


def test_nonfinite_reconstruction_is_caught_by_the_gate_as_in_jax():
    """A CRC-valid frame whose scales are NaN decodes; the gate's
    validate_update refuses its tree with the JAX package's reason."""
    from fedcrack_tpu_torch.fed.serialization import validate_update as t_validate

    frame = jf.encode_frame("int8", 1, 0, [{"shape": [4], "enc": "int8", "bucket": 4,
                                            "scales": np.float32([np.nan]).tobytes()}], bytes(4))
    want, _ = jf.decode_update(frame, template=_w(), base=_w())
    got, _ = tf.decode_update(frame, template=_w(), base=_w())
    assert t_validate(got, _w()) == jser.validate_update(want, _w()) == "leaf 0 has non-finite values"


@pytest.mark.parametrize("codec", ["int8", "topk_delta"])
def test_codecs_refuse_a_nonfinite_delta_as_in_jax(codec):
    base, up = _small(0), _small(1)
    up["params"]["w"][0, 0] = np.nan
    args = (jser.tree_to_bytes(up), jser.tree_to_bytes(base))
    with pytest.raises(ValueError) as want:
        jc.get_codec(codec).encode_update(*args)
    with pytest.raises(ValueError) as got:
        tc.get_codec(codec).encode_update(*args)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="round-base blob"):
        tc.get_codec(codec).encode_update(args[0], None)


def test_frame_fields_round_trip_and_match_jax():
    payload = bytes(range(256)) * 4
    leaves = [{"shape": [4], "enc": "int8"}, {"shape": [2, 2], "enc": "topk", "k": 1}]
    for compress in (True, False):
        blob = tf.encode_frame("int8", 3, 7, leaves, payload, compress=compress)
        assert blob == jf.encode_frame("int8", 3, 7, leaves, payload, compress=compress)
        assert tf.decode_frame(blob) == tf.Frame("int8", 3, 7, tuple(leaves), payload)


def test_quantizer_helpers_match_jax():
    rng = np.random.default_rng(3)
    flat = rng.normal(0, 0.01, 40000).astype(np.float32)
    flat[:16384] = 0.0  # an all-zero bucket has scale 1.0
    for bucket in (1, 7, 16384):
        assert tc.qsgd_scales(flat, bucket).tobytes() == jc.qsgd_scales(flat, bucket).tobytes()
        q, s = tc.int8_quantize(flat, bucket=bucket, seed=(1, 2, 3))
        wq, ws = jc.int8_quantize(flat, bucket=bucket, seed=(1, 2, 3))
        assert q.tobytes() == wq.tobytes() and s.tobytes() == ws.tobytes()
        assert tc.int8_dequantize(q, s, bucket).tobytes() == jc.int8_dequantize(wq, ws, bucket).tobytes()
    ties = np.array([1.0, -1.0, 0.5, 1.0, -1.0, 0.0], np.float32)
    for k in range(0, 8):
        assert tc.topk_select(ties, k).tolist() == jc.topk_select(ties, k).tolist()
    for n in (1, 5, 100, 16385):
        for fraction in (0.001, 0.01, 0.5, 1.0):
            assert tc.leaf_k(n, fraction) == jc.leaf_k(n, fraction)


def test_encoded_bytes_model_and_frame_overhead_match_jax():
    assert tf.FRAME_OVERHEAD_BYTES == jf.FRAME_OVERHEAD_BYTES
    for sizes in ([1000, 10], [4] * 5000, [16384, 16385, 1], []):
        for codec in ("", "null", "int8", "topk_delta"):
            for fraction in (0.01, 0.3):
                assert tc.encoded_bytes_model(sizes, codec, topk_fraction=fraction) == \
                    jc.encoded_bytes_model(sizes, codec, topk_fraction=fraction)
    with pytest.raises(ValueError, match="unknown update codec"):
        tc.encoded_bytes_model([1], "zstd")


def test_codec_registry_matches_jax():
    assert tc.CODEC_NAMES == jc.CODEC_NAMES
    assert tc.DEFAULT_TOPK_FRACTION == jc.DEFAULT_TOPK_FRACTION and tc.QSGD_BUCKET == jc.QSGD_BUCKET
    for name in ("", None, "null"):
        assert isinstance(tc.get_codec(name), tc.NullCodec)
    assert tc.get_codec("int8", client_tag="abc").client_seed == jc.get_codec("int8", client_tag="abc").client_seed
    for bad in (lambda m: m.get_codec("zstd"), lambda m: m.TopKDeltaCodec(fraction=0.0),
                lambda m: m.Int8Codec(bucket=0)):
        with pytest.raises(ValueError) as want:
            bad(jc)
        with pytest.raises(ValueError) as got:
            bad(tc)
        assert str(got.value) == str(want.value)


def test_crc32c_compiled_table_and_jax_agree_on_every_length():
    from fedcrack_tpu.native import crc32c as jax_crc
    from fedcrack_tpu_torch.native import crc32c, crc32c_table

    buf = np.random.default_rng(11).integers(0, 256, 4099, dtype=np.uint8).tobytes()
    running = 0  # the table version continued byte by byte: crc(buf[:n])
    for n in range(0, 4100):
        want = jax_crc(buf[:n])
        assert crc32c(buf[:n]) == want, n
        assert running == want, n
        if n < len(buf):
            running = crc32c_table(buf[n:n + 1], init=running)
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 1000, 4099):
        assert crc32c_table(buf[:n]) == crc32c(buf[:n]) == jax_crc(buf[:n])
        assert crc32c(buf[:n], init=0xDEADBEEF) == jax_crc(buf[:n], 0xDEADBEEF)
    arr = np.arange(12, dtype=np.float64).reshape(3, 4)[:, ::2]
    assert crc32c(arr) == jax_crc(arr) == crc32c_table(arr)
    assert crc32c(memoryview(buf)[3:77]) == crc32c(bytearray(buf[3:77])) == jax_crc(buf[3:77])


def test_bf16_wire_delta_base_is_the_broadcast_blob():
    """tests/test_compress.py's case through the port's round machine: on
    a bfloat16 wire the int8 delta applies to the bf16 broadcast the
    client pulled, and both packages' globals come out byte-equal."""
    from fedcrack_tpu.configs import FedConfig as JaxFedConfig
    from fedcrack_tpu.fed import rounds as JR
    from fedcrack_tpu_torch.configs import FedConfig
    from fedcrack_tpu_torch.fed import rounds as TR

    kw = dict(max_rounds=2, cohort_size=2, registration_window_s=100.0, update_codec="int8",
              wire_dtype="bfloat16")
    start = {"params": {"w": np.full((64, 64), 1000.3, np.float32)}}
    states = {}
    for R, cfg in ((JR, JaxFedConfig(**kw)), (TR, FedConfig(**kw))):
        state = R.initial_state(cfg, start)
        for name in ("a", "b"):
            state, _ = R.transition(state, R.Ready(cname=name, now=0.0))
        for name, value, ns in (("a", 1001.0, 10), ("b", 1003.0, 30)):
            up = jser.tree_to_bytes({"params": {"w": np.full((64, 64), value, np.float32)}})
            frame = jc.get_codec("int8", client_tag=name).encode_update(up, state.broadcast_blob, round=1,
                                                                        base_version=0)
            state, rep = R.transition(state, R.TrainDone(name, round=1, blob=frame, num_samples=ns, now=1.0))
        assert rep.status == R.RESP_ARY
        states[R] = state
    assert states[TR].global_blob == states[JR].global_blob
    assert states[TR].broadcast_blob == states[JR].broadcast_blob
    got = jser.tree_from_bytes(states[TR].global_blob)["params"]["w"]
    assert abs(float(got.mean()) - 1002.5) < 0.05  # the bf16 base, not the f32 one
