"""Checkpoint interchange between the JAX package and the PyTorch port.

The same state must give the same manifest records (sha1 chunk addresses,
crcs, codecs, int8 scales) in both packages; a checkpoint that either one
writes (v1 full or v2 delta, raw or int8) must restore bit-identically in
the other; and the device-delta tracker must pick the same dirty blocks and
account the same device-to-host bytes for the same churn."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.checkpoint import serialize as jser  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.checkpoint.device_delta import DeltaBlocks  # noqa: E402

CHUNK = 64 * 1024
BF16 = ml_dtypes.bfloat16


def nest(named: dict) -> dict:
    root: dict = {}
    for name, v in named.items():
        node = root
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v

    def listify(t):
        if not isinstance(t, dict):
            return t
        t = {k: listify(v) for k, v in t.items()}
        if t and all(k.isdigit() for k in t):
            return [t[str(i)] for i in range(len(t))]
        return t
    return listify(root)


def named_state(seed: int = 0) -> dict[str, np.ndarray]:
    """A train-state-shaped tree (names as the trainer's) in numpy."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)
    return {
        "params/embed": f32(64, 1024).astype(BF16),           # 2 blocks
        "params/segments/0/pos0/mlp/up": f32(2, 64, 300).astype(BF16),
        "params/final_norm": f32(64),
        "opt/mu/embed": f32(64, 1024),                          # 4 blocks
        "opt/nu/embed": np.abs(f32(64, 1024)),
        "opt/mu/segments/0/pos0/mlp/up": f32(2, 64, 300),
        "opt/nu/segments/0/pos0/mlp/up": np.abs(f32(2, 64, 300)),
        "opt/mu/final_norm": f32(64),
        "opt/nu/final_norm": np.abs(f32(64)),
        "opt/count": np.array(7, np.int32),
        "step": np.array(7, np.int32),
        "rng": np.array([0, 1], np.uint32),
        "data/next_batch_index": np.array(7, np.int32),
    }


def jax_state(named):
    return nest({k: jnp.asarray(v) for k, v in named.items()})


def torch_state(named):
    return nest({k: tser.numpy_to_tensor(np.array(v), v.dtype.name)
                 for k, v in named.items()})


def torch_template(named):
    return nest({k: torch.zeros(v.shape, dtype=tser.torch_dtype(v.dtype.name))
                 for k, v in named.items()})


def numpy_template(named):
    return nest({k: np.zeros_like(v) for k, v in named.items()})


def host_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = tser.tensor_to_numpy(x.contiguous())
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def flat_bits(tree, flatten) -> dict[str, np.ndarray]:
    return {k: host_bits(v) for k, v in flatten(tree).items()}


def latest_records(store):
    man, reader = store.latest_valid()
    reader.close()
    return man


STORE_KINDS = [
    ("v1_raw", dict(mode="full")),
    ("v2_raw", dict(mode="delta", chunk_size=CHUNK)),
    ("v1_int8", dict(mode="full", quantize_moments=True)),
    ("v2_int8", dict(mode="delta", chunk_size=CHUNK, quantize_moments=True)),
]


@pytest.mark.parametrize("kind,kw", STORE_KINDS, ids=[k for k, _ in STORE_KINDS])
def test_same_state_same_manifest_records(tmp_path, kind, kw):
    named = named_state()
    js = jck.CheckpointStore(str(tmp_path / "jax"), **kw)
    ts = tck.CheckpointStore(str(tmp_path / "torch"), **kw)
    js.save(7, jax_state(named))
    ts.save(7, torch_state(named))
    jm, tm = latest_records(js), latest_records(ts)
    assert tm.format_version == jm.format_version
    assert tm.leaf_order == jm.leaf_order
    assert tm.tensors == jm.tensors            # sha1 refs, crcs, codecs, scales
    if kind.startswith("v1"):
        a, = (tmp_path / "jax").glob("*/shard_p000.spot")
        b, = (tmp_path / "torch").glob("*/shard_p000.spot")
        assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("kind,kw", STORE_KINDS, ids=[k for k, _ in STORE_KINDS])
def test_interchange_both_ways(tmp_path, kind, kw):
    named = named_state(1)
    js = jck.CheckpointStore(str(tmp_path / "jax"), **kw)
    ts = tck.CheckpointStore(str(tmp_path / "torch"), **kw)
    js.save(3, jax_state(named))
    ts.save(3, torch_state(named))
    # each package restores both checkpoints; all four must agree bit for bit
    j_own, _ = js.restore(numpy_template(named))
    t_own, _ = ts.restore(torch_template(named))
    j_from_t, _ = jck.CheckpointStore(str(tmp_path / "torch"), **kw).restore(
        numpy_template(named))
    t_from_j, _ = tck.CheckpointStore(str(tmp_path / "jax"), **kw).restore(
        torch_template(named), streaming=True)
    want = flat_bits(j_own, jser.flatten_state)
    for got in (flat_bits(t_own, tser.flatten_state),
                flat_bits(j_from_t, jser.flatten_state),
                flat_bits(t_from_j, tser.flatten_state)):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if not kw.get("quantize_moments"):          # raw: exactly the saved state
        for k, v in named.items():
            np.testing.assert_array_equal(want[k], host_bits(v), err_msg=k)


def test_restore_into_tensor_specs(tmp_path):
    named = named_state(2)
    js = jck.CheckpointStore(str(tmp_path), mode="delta", chunk_size=CHUNK)
    js.save(1, jax_state(named))
    spec = nest({k: tck.TensorSpec(v.shape, tser.torch_dtype(v.dtype.name),
                                   torch.device("cpu"))
                 for k, v in named.items()})
    ts = tck.CheckpointStore(str(tmp_path), mode="delta", chunk_size=CHUNK)
    for streaming in (False, True):
        got, man = ts.restore(spec, streaming=streaming)
        assert man.step == 1
        flat = tser.flatten_state(got)
        for k, v in named.items():
            assert isinstance(flat[k], torch.Tensor)
            np.testing.assert_array_equal(host_bits(flat[k]), host_bits(v))


def test_urgent_on_device_quantize_matches_reference(tmp_path):
    """The urgent save's on-device quantize (the quantize kernels' path)
    writes the records the reference's urgent save writes."""
    named = named_state(3)
    jsnap = jck.extract_snapshot(jax_state(named), step=5,
                                 on_device_quantize=jser.is_moment_name)
    tsnap = tck.extract_snapshot(torch_state(named), step=5,
                                 on_device_quantize=tser.is_moment_name)
    kw = dict(mode="delta", chunk_size=CHUNK, quantize_moments=True)
    js = jck.CheckpointStore(str(tmp_path / "jax"), **kw)
    ts = tck.CheckpointStore(str(tmp_path / "torch"), **kw)
    js.save_snapshot(jsnap, kind="termination")
    ts.save_snapshot(tsnap, kind="termination")
    assert latest_records(ts).tensors == latest_records(js).tensors
    moments = [k for k in named if tser.is_moment_name(k) and named[k].ndim]
    assert moments and all(tsnap.leaves[k].prequant == "int8" for k in moments)


def _perturb(named, rng, n_edits):
    out = {k: v.copy() for k, v in named.items()}
    for _ in range(n_edits):
        k = ["params/embed", "opt/mu/embed", "opt/nu/segments/0/pos0/mlp/up"][
            int(rng.integers(3))]
        flat = out[k].reshape(-1)
        i = int(rng.integers(flat.size))
        flat[i] = (flat[i].astype(np.float32) + np.float32(1.0)).astype(flat.dtype)
    return out


@pytest.mark.parametrize("n_edits", [0, 1, 3, 40])
def test_tracker_same_dirty_blocks_and_d2h_as_reference(tmp_path, n_edits):
    named0 = named_state(4)
    rng = np.random.default_rng(n_edits)
    named1 = _perturb(named0, rng, n_edits)
    kw = dict(mode="delta", chunk_size=CHUNK)
    js = jck.CheckpointStore(str(tmp_path / "jax"), **kw)
    ts = tck.CheckpointStore(str(tmp_path / "torch"), **kw)
    jt = jck.DeviceDeltaTracker(js.pool, chunk_size=CHUNK, compress=js.compress)
    tt = tck.DeviceDeltaTracker(ts.pool, chunk_size=CHUNK, compress=ts.compress)
    js.save(0, jax_state(named0), tracker=jt)
    ts.save(0, torch_state(named0), tracker=tt)
    jsnap = jck.extract_snapshot(jck.prestage(jax_state(named1), jt), step=1,
                                 tracker=jt)
    tsnap = tck.extract_snapshot(tck.prestage(torch_state(named1), tt), step=1,
                                 tracker=tt)

    def dirty(snap, cls):
        return {n: lp.pieces[0][1].dirty_ids for n, lp in snap.leaves.items()
                if isinstance(lp.pieces[0][1], cls)}
    assert dirty(tsnap, DeltaBlocks) == dirty(
        jsnap, jck.device_delta.DeltaBlocks)
    assert tsnap.d2h_bytes == jsnap.d2h_bytes
    assert tsnap.d2h_skipped == jsnap.d2h_skipped
    assert tt.stats == jt.stats
    js.save_snapshot(jsnap)
    ts.save_snapshot(tsnap)
    assert latest_records(ts).tensors == latest_records(js).tensors
    got, _ = ts.restore(torch_template(named1))
    for k, v in tser.flatten_state(got).items():
        np.testing.assert_array_equal(host_bits(v), host_bits(named1[k]))


def test_flatten_names_match_reference_key_paths():
    named = named_state()
    jn = list(jser.flatten_state(jax_state(named)))
    tn = list(tser.flatten_state(torch_state(named)))
    assert tn == jn
    assert "params/segments/0/pos0/mlp/up" in tn


def test_bfloat16_host_round_trip_without_ml_dtypes():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4096) * 50).astype(np.float32)
    x[:4] = [np.inf, -np.inf, np.nan, 3.3895314e38]      # edge values
    want = x.astype(BF16)
    got_bits = tser.f32_to_bf16_bits(x)
    np.testing.assert_array_equal(got_bits, want.view(np.uint16))
    np.testing.assert_array_equal(tser.bf16_bits_to_f32(got_bits).view(np.uint32),
                                  want.astype(np.float32).view(np.uint32))
    t = tser.numpy_to_tensor(want, "bfloat16")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(tser.to_host(t), want.view(np.uint16))
