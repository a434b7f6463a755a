"""The port's urgent-save path on the CPU: the chunk digests computed apart
from the bytes (the card's ``chunk_digest`` kernel; here its plain version),
the urgent IO pool's writes, the pinned staging pool and the hold on
periodic chunk writes. Whatever path an urgent save takes, it must store
the bytes and addresses the reference stores: the manifests' chunk
references are compared with a reference save of the same state.
"""

from __future__ import annotations

import hashlib
import threading
import zlib

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointStore as RefStore  # noqa: E402
from repro.checkpoint import chunkstore as ref_chunkstore  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint import chunkstore, hostcopy  # noqa: E402
from repro_torch.checkpoint import sharded  # noqa: E402
from repro_torch.kernels.chunk_digest import (chunk_digests,  # noqa: E402
                                              chunk_digests_ref)

CHUNK = 4096


def payloads():
    g = torch.Generator().manual_seed(0)
    return [torch.randn(3 * CHUNK // 4 + 5, generator=g),
            torch.randn(CHUNK + 7, generator=g).to(torch.bfloat16),
            torch.randint(-128, 127, (5 * CHUNK + 3,), dtype=torch.int8,
                          generator=g),
            torch.zeros(0), torch.arange(3, dtype=torch.int64)]


@pytest.mark.parametrize("i", range(5))
def test_plain_digests_are_the_pools_digests(i):
    t = payloads()[i]
    raw = sharded.ser.array_bytes_view(sharded.ser.to_host(t))
    want = [(ref_chunkstore.chunk_digest(raw[o:o + CHUNK]),
             zlib.crc32(raw[o:o + CHUNK])) for o in range(0, len(raw), CHUNK)]
    assert chunk_digests_ref(t, CHUNK) == want
    assert chunk_digests([t], CHUNK).result() == [want]


def test_chunk_size_must_be_a_multiple_of_64():
    with pytest.raises(ValueError):
        chunk_digests(payloads()[:1], 1000)


@pytest.mark.parametrize("urgent", [False, True])
def test_given_digests_store_the_same_chunks(tmp_path, urgent):
    """``store_payload_chunks`` with digests computed apart from the bytes
    writes the refs, files and byte counts of the host digests — serially
    or through an urgent save's writes."""
    t = payloads()[2]
    raw = sharded.ser.array_bytes_view(sharded.ser.to_host(t))
    out = {}
    for given in (False, True):
        pool = chunkstore.ChunkPool(str(tmp_path / f"{urgent}{given}"))
        dirty: set = set()
        writes = chunkstore.ChunkWrites(pool, dirty) if urgent else None
        refs, written = chunkstore.store_payload_chunks(
            pool, ("m", 0), raw, codec="raw", comp="raw", chunk_size=CHUNK,
            dirty_dirs=dirty, writes=writes,
            digests=chunk_digests_ref(t, CHUNK) if given else None)
        if writes is not None:
            written += writes.wait()
        files = {h: open(p, "rb").read() for h, p in pool.all_chunks()}
        out[given] = (refs, written, files)
    assert out[True] == out[False]
    refs, written, files = out[True]
    assert written == len(raw)
    assert all(hashlib.sha1(b).hexdigest() == h for h, b in files.items())


def test_urgent_writes_dedup_and_raise_after_all_land(tmp_path):
    pool = chunkstore.ChunkPool(str(tmp_path))
    dirty: set = set()
    writes = chunkstore.ChunkWrites(pool, dirty)
    data = b"x" * CHUNK
    h = chunkstore.chunk_digest(data)
    for _ in range(3):
        writes.submit(h, data)
    assert writes.wait() == CHUNK         # one address, written once
    assert dirty and pool.check(h, CHUNK)

    class Broken(chunkstore.ChunkPool):
        def write(self, h, data, **kw):
            raise OSError(28, "No space left on device")

    bad = chunkstore.ChunkWrites(Broken(str(tmp_path / "b")), set())
    bad.submit("ab" * 20, b"y")
    bad.submit("cd" * 20, b"z")
    with pytest.raises(OSError):
        bad.wait()


def _state(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                rng.standard_normal((96, 256)).astype(np.float32)).to(
                torch.bfloat16)},
            "opt": {"mu": {"w": torch.from_numpy(
                rng.standard_normal((96, 256)).astype(np.float32))}},
            "step": seed}


def _records(store, step):
    man, reader = store.latest_valid()
    reader.close()
    assert man.step == step
    return {r["name"]: [c["h"] for c in r["chunks"]] for r in man.tensors}


def test_urgent_save_stores_what_the_reference_stores(tmp_path):
    """An urgent (termination) save in the port and a save of the same
    state in the reference reference the same chunks, and the port's
    restores in the reference bit for bit."""
    state = _state(4)
    port = CheckpointStore(str(tmp_path / "port"), chunk_size=CHUNK)
    snap = sharded.extract_snapshot(state, step=4,
                                    digest_chunk=port.urgent_digest_chunk)
    port.save_snapshot(snap, kind="termination")
    host = {"params": {"w": sharded.ser.to_host(state["params"]["w"])},
            "opt": {"mu": {"w": state["opt"]["mu"]["w"].numpy()}}, "step": 4}
    ref = RefStore(str(tmp_path / "ref"), chunk_size=CHUNK)
    ref.save(4, host)
    assert _records(port, 4) == _records(ref, 4)
    got, man = RefStore(str(tmp_path / "port"), chunk_size=CHUNK).restore(
        {"params": {"w": np.zeros((96, 256), ml_dtypes.bfloat16)},
         "opt": {"mu": {"w": np.zeros((96, 256), np.float32)}}, "step": 0})
    assert man.kind == "termination" and got["step"] == 4
    assert np.asarray(got["params"]["w"]).view(np.uint16).tobytes() == \
        host["params"]["w"].tobytes()
    assert np.array_equal(np.asarray(got["opt"]["mu"]["w"]),
                          host["opt"]["mu"]["w"])


STORES = [dict(mode="delta", compress=False),
          dict(mode="delta", compress=True),
          dict(mode="delta", compress=True, quantize_moments=True),
          dict(mode="delta", compress=False, quantize_moments=True),
          dict(mode="full", compress=False)]
LEAVES = [("params/w", torch.zeros(64, 32, dtype=torch.bfloat16), False),
          ("opt/mu/w", torch.zeros(64, 32), False),
          ("opt/mu/w", torch.zeros(64, 32, dtype=torch.int8), True),
          ("data/ids", torch.zeros(4096, dtype=torch.int32), False),
          ("step", torch.zeros((), dtype=torch.int64), False)]


@pytest.mark.parametrize("kw", STORES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_urgent_digests_only_where_the_store_keeps_raw_chunks(tmp_path, kw):
    """The store names a chunk size for a leaf (the tensor copied: int8
    for a moment quantized on the device) exactly where the write stores
    that leaf's chunks as the copied bytes (``_piece_codec``: no host
    quantize, no compression), so no device digest is thrown away."""
    store = CheckpointStore(str(tmp_path), chunk_size=CHUNK, **kw)
    for name, t, prequant in LEAVES:
        arr = sharded.ser.to_host(t)
        lp = sharded.LeafPieces(tuple(arr.shape),
                                sharded.ser.dtype_to_name(t.dtype), [],
                                prequant="int8" if prequant else "")
        codec = sharded.ser.resolve_codec(sharded._piece_codec(
            name, lp, arr, compress=store.compress,
            quantize_moments=store.quantize_moments))
        quant, comp = sharded.ser.split_codec(codec)
        raw = comp in ("", "raw") and (prequant or not quant)
        got = store.urgent_digest_chunk(name, t)
        assert got == (CHUNK if raw and kw["mode"] == "delta" else None), \
            (name, codec)


def test_digests_of_other_bytes_than_the_stored_are_refused(tmp_path):
    pool = chunkstore.ChunkPool(str(tmp_path))
    arr = np.zeros(CHUNK, np.float32)
    with pytest.raises(ValueError, match="device digests"):
        sharded._delta_encode_piece(
            pool, ("w", 0), arr, "zlib", CHUNK, None, lambda h: None,
            digests=[("0" * 40, 0)] * 4)


class TestPinnedStaging:
    def pool(self):
        return hostcopy.PinnedStaging(
            alloc=lambda n: torch.empty(n, dtype=torch.uint8))

    def test_a_given_buffer_is_taken_again(self):
        st = self.pool()
        st.reserve([1000]).join()
        a = st.take(1000)
        st.give(a)
        assert st.take(1000) is a
        assert st.stats == {"reused": 2, "allocated": 0, "spares": 1,
                            "let_go": 0}

    def test_spares_are_pinned_for_what_had_to_be_pinned(self):
        """``reserve`` pins what the free set lacks of the set it names,
        in the background; a set already free pins nothing."""
        st = self.pool()
        st.take(1000)
        st.reserve([1000, 2000, 2000]).join()
        assert st.held_bytes() == 5000 and st.stats["spares"] == 3
        assert st.reserve([1000, 2000, 2000]) is None
        st.take(2000)
        st.reserve([1000, 2000, 2000]).join()
        assert st.held_bytes() == 5000 and st.stats["spares"] == 4

    def test_the_cap_lets_the_oldest_sizes_go(self):
        """The free set is held to one set of the sizes last reserved: a
        buffer given beyond it, and every size the set no longer names,
        is let go."""
        st = self.pool()
        st.reserve([1000, 1500]).join()
        a, c = st.take(1000), st.take(1500)
        extra = torch.empty(1000, dtype=torch.uint8)
        st.give(a)
        st.give(extra)                      # a second 1000: beyond the set
        st.give(c)
        assert st.held_bytes() == 2500 and st.stats["let_go"] == 1
        assert st.reserve([1500]) is None   # the 1000 goes, the 1500 stays
        assert st.held_bytes() == 1500
        assert st.take(1500) is c


def test_periodic_chunk_loop_holds_in_an_urgent_window(tmp_path):
    """``wait_out_urgent`` returns only once the urgent window closes."""
    released = threading.Event()

    def periodic():
        chunkstore.wait_out_urgent()
        released.set()

    with chunkstore.urgent_window():
        t = threading.Thread(target=periodic, daemon=True)
        t.start()
        assert not released.wait(0.2)
    assert released.wait(5)
    t.join(5)


@pytest.mark.parametrize("policy,notice_first,want", [
    ("transparent", False, [[1234]]),
    ("transparent", True, []),
    ("off", False, [])])
def test_first_step_of_an_instance_reserves_its_urgent_buffers(
        tmp_path, monkeypatch, policy, notice_first, want):
    """An instance may be evicted before its first periodic save: the first
    step after ``attach_instance`` with no notice pending reserves the
    urgent save's pinned buffers (``STAGING.reserve``), once an instance;
    not while a notice is being handled (the save takes what it needs
    then), and not under a policy that takes no urgent saves."""
    from repro_torch.core import coordinator as coord_mod
    from repro_torch.core import (CheckpointPolicy, Signal,
                                  SimulatedMetadataService, SpotOnCoordinator,
                                  VirtualClock)
    calls = []

    class FakeStaging:
        def reserve(self, sizes):
            calls.append(list(sizes))

    monkeypatch.setattr(coord_mod, "STAGING", FakeStaging())
    monkeypatch.setattr(coord_mod, "urgent_staging_sizes",
                        lambda state, quantize_moments: [1234])
    monkeypatch.setattr(SpotOnCoordinator, "_save_termination",
                        lambda self, step, state, deadline: True)
    clock = VirtualClock()
    pol = (CheckpointPolicy.transparent(1e9) if policy == "transparent"
           else CheckpointPolicy.off())
    coord = SpotOnCoordinator(CheckpointStore(str(tmp_path)), pol, clock)
    meta = SimulatedMetadataService(clock, "vm-0")
    if notice_first:
        meta.schedule_preempt()
    coord.attach_instance(meta, "vm-0")
    state = {"w": torch.zeros(3)}
    if notice_first:     # the trainer stops stepping on a notice
        assert coord.on_step_end(1, lambda: state) is Signal.PREEMPTING
    else:
        for step in (1, 2, 3):
            assert coord.on_step_end(step, lambda: state) is Signal.CONTINUE
            clock.advance(2.0)
    coord.close()
    assert calls == want
