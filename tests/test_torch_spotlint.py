"""The port's analyzer (``repro_torch.analysis``) and its lock witness, held
against the JAX package's (twins of ``tests/test_spotlint.py``).

The seeded-violation fixtures of ``tests/spotlint_fixtures/`` carry
``# SPOTLINT-EXPECT: CODE`` markers; each twin asserts the port's analyzer
reports exactly the marked set, and a parity case asserts it reports, on
``src/repro`` and on every fixture, exactly what the reference's analyzer
reports. The port's SPOT021 also covers ``repro_torch.checkpoint.*`` with
torch's aliasing forms: the fixtures in ``tests/spotlint_fixtures_torch/``
are analyzed from a scratch ``src/repro_torch/checkpoint/`` tree. The
witness wraps the port's locks and none of the reference's. Only the parity
and stacking cases import the reference.
"""

import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import lock_witness  # noqa: E402
from repro_torch.analysis.spotlint import analyze, collect_files  # noqa: E402
from repro_torch.checkpoint import (CheckpointStore, codec_sched,  # noqa: E402
                                    hostcopy, sharded)
from repro_torch.checkpoint.codec_sched import (PERIODIC,  # noqa: E402
                                                CodecScheduler)
from repro_torch.checkpoint.peer_exchange import FleetPeerExchange  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "spotlint_fixtures"
TORCH_FIXTURES = Path(__file__).resolve().parent / "spotlint_fixtures_torch"

EXPECT_RE = re.compile(r"#\s*SPOTLINT-EXPECT:\s*([A-Z0-9,\s]+)")
FINDING_RE = re.compile(r"^(.*?):(\d+):(\d+): (SPOT\d+) ")

# the reference's ten rule fixtures; noncopied_leaf.py needs the
# checkpoint scope and has cases of its own
FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("*.py")
                       if p.name != "noncopied_leaf.py")
TORCH_FIXTURE_FILES = sorted(p.name for p in TORCH_FIXTURES.glob("*.py"))


def expected_findings(path: Path) -> set:
    exp = set()
    for lineno, line in enumerate(path.read_text().splitlines(), start=1):
        m = EXPECT_RE.search(line)
        if m:
            exp |= {(code.strip(), lineno)
                    for code in m.group(1).split(",") if code.strip()}
    return exp


def spotlint(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.spotlint", *args],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=300)


def cli_findings(stdout: str) -> set:
    got = set()
    for line in stdout.splitlines():
        m = FINDING_RE.match(line)
        if m:
            got.add((m.group(4), int(m.group(2))))
    return got


def in_checkpoint_tree(tmp_path, src: Path, package="repro_torch") -> str:
    """Copy ``src`` into ``tmp_path/src/<package>/checkpoint/``; the path
    relative to ``tmp_path``, whence the module name is read."""
    rel = Path("src") / package / "checkpoint" / src.name
    (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, tmp_path / rel)
    return str(rel)


def test_ten_reference_fixtures():
    assert len(FIXTURE_FILES) == 10 and len(TORCH_FIXTURE_FILES) == 3


class TestFixtures:
    @pytest.mark.parametrize("fname", FIXTURE_FILES)
    def test_fixture_flagged_exactly(self, fname):
        path = FIXTURES / fname
        exp = expected_findings(path)
        assert exp, f"{fname} carries no SPOTLINT-EXPECT markers"
        got = {(f.code, f.line) for f in analyze([str(path)])}
        assert got == exp

    @pytest.mark.parametrize("package", ["repro", "repro_torch"])
    def test_noncopied_leaf_scoped_to_checkpoint(self, tmp_path, package):
        # SPOT021 applies inside repro.checkpoint.* (the reference's rule)
        # and repro_torch.checkpoint.* (the port's, with torch's forms):
        # the reference's fixture flags the same lines in both
        in_checkpoint_tree(tmp_path, FIXTURES / "noncopied_leaf.py", package)
        res = spotlint("--no-baseline", "src", cwd=tmp_path)
        assert res.returncode == 1, res.stdout + res.stderr
        assert cli_findings(res.stdout) == expected_findings(
            FIXTURES / "noncopied_leaf.py")

    def test_noncopied_leaf_silent_outside_checkpoint(self):
        assert analyze([str(FIXTURES / "noncopied_leaf.py")]) == []


class TestTorchFixtures:
    @pytest.mark.parametrize("fname", TORCH_FIXTURE_FILES)
    def test_torch_fixture_flagged_exactly(self, tmp_path, monkeypatch,
                                           fname):
        exp = expected_findings(TORCH_FIXTURES / fname)
        assert exp, f"{fname} carries no SPOTLINT-EXPECT markers"
        rel = in_checkpoint_tree(tmp_path, TORCH_FIXTURES / fname)
        monkeypatch.chdir(tmp_path)
        got = {(f.code, f.line) for f in analyze([rel])}
        assert got == exp

    def test_torch_fixtures_through_the_cli(self, tmp_path):
        exp = set()
        for fname in TORCH_FIXTURE_FILES:
            in_checkpoint_tree(tmp_path, TORCH_FIXTURES / fname)
            exp |= {(code, fname, line) for code, line
                    in expected_findings(TORCH_FIXTURES / fname)}
        res = spotlint("--no-baseline", "src", cwd=tmp_path)
        assert res.returncode == 1, res.stdout + res.stderr
        got = {(m.group(4), Path(m.group(1)).name, int(m.group(2)))
               for m in map(FINDING_RE.match, res.stdout.splitlines()) if m}
        assert got == exp

    @pytest.mark.parametrize("fname", TORCH_FIXTURE_FILES)
    def test_torch_fixture_silent_outside_checkpoint(self, fname):
        assert analyze([str(TORCH_FIXTURES / fname)]) == []

    @pytest.mark.parametrize("fname", TORCH_FIXTURE_FILES)
    def test_reference_checkpoint_keeps_the_reference_rule(
            self, tmp_path, monkeypatch, fname):
        # in repro.checkpoint.* the rule stays the reference's, which knows
        # no torch form: it reports what the reference's analyzer reports
        from repro.analysis.spotlint import analyze as ref_analyze
        rel = in_checkpoint_tree(tmp_path, TORCH_FIXTURES / fname, "repro")
        monkeypatch.chdir(tmp_path)
        got = {(f.line, f.col, f.code) for f in analyze([rel])}
        assert got == {(f.line, f.col, f.code) for f in ref_analyze([rel])}


class TestRestoredLeavesOwnTheirMemory:
    """What the suppression at ``sharded._tensor_from_payload`` rests on: a
    CPU restore's tensor leaves share no memory with each other, with a
    second restore or with the saved state, even where two leaves hold the
    same bytes (one content-addressed chunk)."""

    @pytest.mark.parametrize("mode", ["full", "delta"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_cpu_restore(self, tmp_path, mode, dtype):
        g = torch.Generator().manual_seed(0)
        w = torch.randn(64, 64, generator=g).to(dtype)
        state = {"a": w, "b": w.clone(), "c": torch.randn(64, generator=g)}
        store = CheckpointStore(str(tmp_path / "ckpt"), mode=mode)
        store.save(1, state)
        template = {k: torch.zeros_like(v) for k, v in state.items()}
        first, _ = store.restore(template)
        second, _ = store.restore(template)
        leaves = [first[k] for k in state] + [second[k] for k in state]
        ptrs = [t.untyped_storage().data_ptr() for t in leaves]
        assert len(set(ptrs)) == len(ptrs)
        first["a"].add_(1)
        for got in (first["b"], second["a"], state["a"]):
            assert torch.equal(got, w)


class TestCli:
    def test_repo_is_clean(self):
        res = spotlint("src")
        assert res.returncode == 0, res.stdout + res.stderr
        assert "spotlint: clean" in res.stdout

    @pytest.mark.parametrize("fname", FIXTURE_FILES)
    def test_nonzero_on_seeded_fixture(self, fname):
        res = spotlint("--no-baseline", str(FIXTURES / fname))
        assert res.returncode == 1, res.stdout + res.stderr
        assert cli_findings(res.stdout) == expected_findings(FIXTURES / fname)

    def test_baseline_suppresses_then_goes_stale(self, tmp_path):
        code_dir = tmp_path / "code"
        code_dir.mkdir()
        mod = code_dir / "mod.py"
        mod.write_text(
            "import os\n\n\ndef commit(tmp, path):\n"
            "    os.replace(tmp, path)\n")
        baseline = tmp_path / "lint.baseline"
        baseline.write_text(
            "code/mod.py\tSPOT001\t5\tos.replace(tmp, path)\n"
            "code/mod.py\tSPOT002\t5\tos.replace(tmp, path)\n")
        args = ("--baseline", str(baseline), "code")
        res = spotlint(*args, cwd=tmp_path)
        assert res.returncode == 0, res.stdout + res.stderr
        # the suppressed line changes: the entry is stale and fails the run
        mod.write_text(
            "import os\n\n\ndef commit(tmp, path):\n"
            "    os.replace(tmp, path + '.new')\n")
        res = spotlint(*args, cwd=tmp_path)
        assert res.returncode == 1, res.stdout + res.stderr
        assert "stale-baseline" in res.stdout + res.stderr


class TestParity:
    """Outside ``repro_torch.checkpoint`` the port's rules are the
    reference's: both analyzers report the same (path, line, col, code)."""

    @staticmethod
    def keys(findings) -> set:
        return {(f.path, f.line, f.col, f.code) for f in findings}

    def test_reference_package(self):
        from repro.analysis.spotlint import analyze as ref_analyze
        files = collect_files([os.path.relpath(REPO / "src" / "repro")])
        want = self.keys(ref_analyze(files))
        assert want, "the reference's own findings (baselined) are expected"
        assert self.keys(analyze(files)) == want

    @pytest.mark.parametrize("fname", FIXTURE_FILES + ["noncopied_leaf.py"])
    def test_fixture(self, fname):
        from repro.analysis.spotlint import analyze as ref_analyze
        files = [str(FIXTURES / fname)]
        assert self.keys(analyze(files)) == self.keys(ref_analyze(files))

    def test_noncopied_leaf_in_reference_checkpoint(self, tmp_path,
                                                    monkeypatch):
        from repro.analysis.spotlint import analyze as ref_analyze
        files = [in_checkpoint_tree(tmp_path, FIXTURES / "noncopied_leaf.py",
                                    "repro")]
        monkeypatch.chdir(tmp_path)
        want = self.keys(ref_analyze(files))
        assert want and self.keys(analyze(files)) == want


class TestLaneDiscipline:
    """SPOT011 on the port's restore-window submit sites: lane-correct, and
    the rule catches them drifting to the encode lane."""

    REAL = ["src/repro_torch/checkpoint/peer_exchange.py",
            "src/repro_torch/checkpoint/sharded.py"]

    def _mirror(self, tmp_path, relpath: str) -> Path:
        target = tmp_path / relpath
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / relpath, target)
        return target

    @pytest.mark.parametrize("relpath", REAL)
    def test_restore_submit_sites_clean(self, tmp_path, relpath):
        target = self._mirror(tmp_path, relpath)
        codes = {f.code for f in analyze([str(target)])}
        assert "SPOT011" not in codes

    @pytest.mark.parametrize("relpath", REAL)
    def test_lane_drift_is_caught(self, tmp_path, relpath):
        # restore_executor() -> codec_executor(): every restore-path submit
        # site must light up SPOT011
        target = self._mirror(tmp_path, relpath)
        src = target.read_text()
        assert "restore_executor()" in src
        target.write_text(src.replace("restore_executor()",
                                      "codec_executor()"))
        codes = {f.code for f in analyze([str(target)])}
        assert "SPOT011" in codes


class TestLockWitness:
    def _local(self):
        # locks created from this file only, whatever else the session does
        return lock_witness.LockWitness(
            path_filter=lambda fn: fn == __file__)

    def test_abba_inversion_detected(self):
        w = self._local()
        w.install()
        try:
            a = threading.Lock()
            b = threading.Lock()
            with a:
                with b:
                    pass
            with b:  # the opposite order: a latent deadlock
                with a:
                    pass
        finally:
            w.uninstall()
        inv = w.inversions()
        assert len(inv) == 1 and "inversion" in inv[0]
        rep = w.report()
        assert rep["sites"] == 2 and len(rep["edges"]) == 2
        assert rep["inversions"] == inv

    def test_consistent_order_is_clean(self):
        w = self._local()
        w.install()
        try:
            a = threading.Lock()
            b = threading.Lock()
            for _ in range(3):
                with a:
                    with b:
                        pass
        finally:
            w.uninstall()
        assert w.inversions() == []
        assert len(w.report()["edges"]) == 1

    def test_condition_wait_releases_held_state(self):
        w = self._local()
        w.install()
        try:
            cond = threading.Condition()
            other = threading.Lock()
            with cond:
                cond.wait(timeout=0.01)
                with other:
                    pass
            with other:
                pass
        finally:
            w.uninstall()
        assert w.inversions() == []

    def test_default_filter_wraps_the_port_and_not_the_reference(self):
        f = lock_witness._default_path_filter
        port = REPO / "src" / "repro_torch" / "checkpoint" / "store.py"
        ref = REPO / "src" / "repro" / "checkpoint" / "store.py"
        assert f(str(port))
        assert not f(str(ref))
        assert not f(str(REPO / "src" / "repro_torch" / "analysis"
                         / "lock_witness.py"))
        w = lock_witness.LockWitness()
        w.install()
        try:
            codec_sched._reset_for_tests()
            s = codec_sched.scheduler()
            from repro.checkpoint import codec_sched as ref_sched
            ref_s = ref_sched.CodecScheduler(max_workers=1)
        finally:
            w.uninstall()
        try:
            assert type(s._cond).__name__ == "_WitnessCondition"
            assert type(ref_s._cond).__name__ == "Condition"
        finally:
            ref_s.shutdown(wait=True, timeout=10.0)
            codec_sched._reset_for_tests()

    def test_stacked_with_the_reference_witness(self):
        """With the reference's witness installed over the port's (as
        ``SPOTON_LOCK_WITNESS`` with ``tests/conftest.py`` and this
        package's plugin do), each still wraps its own package's locks."""
        from repro.analysis import lock_witness as ref_witness
        from repro.checkpoint import codec_sched as ref_sched
        port_w = lock_witness.LockWitness()
        port_w.install()
        ref_w = ref_witness.LockWitness()     # wraps the port's factories
        ref_w.install()
        try:
            port_s = CodecScheduler(max_workers=1)
            ref_s = ref_sched.CodecScheduler(max_workers=1)
        finally:
            ref_w.uninstall()
            port_w.uninstall()
        try:
            assert port_s._cond.__class__ is lock_witness._WitnessCondition
            assert ref_s._cond.__class__ is ref_witness._WitnessCondition
            assert port_w.sites == {"codec_sched.py:96"}
        finally:
            port_s.shutdown(wait=True, timeout=10.0)
            ref_s.shutdown(wait=True, timeout=10.0)

    def test_checkpoint_save_restore_clean_under_witness(self, tmp_path):
        # a fresh scheduler and store made after install get witnessed
        # locks; a delta save and restore must show no inversion
        rng = np.random.default_rng(0)
        w = lock_witness.LockWitness()
        w.install()
        try:
            codec_sched._reset_for_tests()
            store = CheckpointStore(str(tmp_path / "ckpt"), mode="delta")
            state = {"w": torch.from_numpy(
                rng.normal(size=(64, 64)).astype(np.float32))}
            store.save(1, state)
            got, man = store.restore({"w": torch.zeros(64, 64)})
        finally:
            w.uninstall()
            codec_sched._reset_for_tests()
        assert man.step == 1
        assert torch.equal(got["w"], state["w"])
        assert w.inversions() == []
        assert "store.py:169 -> codec_sched.py:96" in w.report()["edges"]

    def test_scheduler_shutdown_clean_under_witness(self):
        w = lock_witness.LockWitness()
        w.install()
        try:
            s = CodecScheduler(max_workers=2)
            futs = [s.submit(PERIODIC, lambda i=i: i * i) for i in range(8)]
            assert [f.result(timeout=10) for f in futs] == \
                [i * i for i in range(8)]
            s.shutdown(wait=True, timeout=10.0)
        finally:
            w.uninstall()
        assert w.inversions() == []

    def test_urgent_save_and_peer_seed_clean_under_witness(self, tmp_path,
                                                           monkeypatch):
        """The urgent save's own locks on the CPU: pinned staging, the
        chunk digests given apart from the bytes, the urgent IO pool's
        writes, the commit; then the notice window's peer seeding."""
        g = torch.Generator().manual_seed(0)
        state = {"params": {"w": torch.randn(96, 256, generator=g).to(
                     torch.bfloat16)},
                 "opt": {"mu": {"w": torch.randn(96, 256, generator=g)}},
                 "step": 3}
        w = lock_witness.LockWitness()
        w.install()
        try:
            codec_sched._reset_for_tests()
            monkeypatch.setattr(hostcopy, "STAGING", hostcopy.PinnedStaging(
                alloc=lambda n: torch.empty(n, dtype=torch.uint8)))
            store = CheckpointStore(str(tmp_path / "store"), chunk_size=4096)
            snap = sharded.extract_snapshot(
                state, step=3, digest_chunk=store.urgent_digest_chunk)
            info = store.save_snapshot(snap, kind="termination")
            exchange = FleetPeerExchange(str(tmp_path / "fabric"), 3)
            try:
                hashes = [h for h, _p in store.pool.all_chunks()]
                seeded = exchange.seed_from(0, store.pool, hashes,
                                            budget_bytes=1 << 30)
            finally:
                exchange.close()
        finally:
            w.uninstall()
            codec_sched._reset_for_tests()
        assert info.step == 3 and seeded["chunks"] == len(hashes) > 0
        rep = w.report()
        assert rep["inversions"] == []
        files = {site.split(":")[0] for site in w.sites}
        assert {"store.py", "codec_sched.py", "chunkstore.py",
                "peer_exchange.py"} <= files
        assert rep["edges"], rep


class TestWitnessBookkeeping:
    """A try or timed acquire that fails records no edge; one that
    succeeds records its edge from each lock the thread holds."""

    def test_a_try_acquire_records_once_it_has_the_lock(self):
        w = lock_witness.LockWitness(path_filter=lambda fn: False)
        a = lock_witness._WitnessLock(threading.Lock(), "a.py:1", w)
        b = lock_witness._WitnessLock(threading.Lock(), "b.py:1", w)
        b._real.acquire()                      # b taken elsewhere
        with a:
            assert not b.acquire(blocking=False)
            assert not b.acquire(timeout=0.01)
        assert w.edges == {}
        b._real.release()
        with a:
            assert b.acquire(blocking=False)
            b.release()
        assert set(w.edges) == {("a.py:1", "b.py:1")}


def _scenario_delta(tmp_path):
    rng = np.random.default_rng(0)
    store = CheckpointStore(str(tmp_path / "ckpt"), mode="delta")
    state = {"w": torch.from_numpy(
        rng.normal(size=(64, 64)).astype(np.float32))}
    store.save(1, state)
    store.restore({"w": torch.zeros(64, 64)})


def _scenario_urgent(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn(96, 256, generator=g).to(
                 torch.bfloat16)},
             "opt": {"mu": {"w": torch.randn(96, 256, generator=g)}},
             "step": 3}
    store = CheckpointStore(str(tmp_path / "store"), chunk_size=4096)
    snap = sharded.extract_snapshot(
        state, step=3, digest_chunk=store.urgent_digest_chunk)
    store.save_snapshot(snap, kind="termination")
    exchange = FleetPeerExchange(str(tmp_path / "fabric"), 3)
    try:
        hashes = [h for h, _p in store.pool.all_chunks()]
        exchange.seed_from(0, store.pool, hashes, budget_bytes=1 << 30)
    finally:
        exchange.close()


def _scenario_scheduler(tmp_path):
    s = CodecScheduler(max_workers=2)
    futs = [s.submit(PERIODIC, lambda i=i: i * i) for i in range(8)]
    [f.result(timeout=10) for f in futs]
    s.shutdown(wait=True, timeout=10.0)


def _scenario_abba(tmp_path):
    from repro_torch.checkpoint import chunkstore
    a = chunkstore.SaveLegs()._lock
    b = chunkstore.ChunkWrites(None, set())._lock
    with a:
        with b:
            pass
    with b:
        with a:
            pass


@pytest.mark.parametrize("scenario", [_scenario_delta, _scenario_urgent,
                                      _scenario_scheduler, _scenario_abba],
                         ids=lambda f: f.__name__[len("_scenario_"):])
def test_edges_and_inversions_match_the_reference_witness(tmp_path,
                                                          monkeypatch,
                                                          scenario):
    """The reference's witness (recording after it has the lock) stacked
    over the port's, both watching the port's locks, on the same run: the
    same edges and inversions (``abba`` takes two of the urgent save's
    locks in both orders)."""
    from repro.analysis import lock_witness as ref_witness
    port_w = lock_witness.LockWitness()
    port_w.install()
    ref_w = ref_witness.LockWitness(path_filter=lambda fn: (
        "/repro_torch/" in fn.replace(os.sep, "/")
        and not fn.endswith("lock_witness.py")))
    ref_w.install()
    try:
        codec_sched._reset_for_tests()
        monkeypatch.setattr(hostcopy, "STAGING", hostcopy.PinnedStaging(
            alloc=lambda n: torch.empty(n, dtype=torch.uint8)))
        scenario(tmp_path)
    finally:
        ref_w.uninstall()
        port_w.uninstall()
        codec_sched._reset_for_tests()
    assert port_w.sites
    assert set(port_w.edges) == set(ref_w.edges)
    assert len(port_w.inversions()) == len(ref_w.inversions())
    if scenario is _scenario_abba:
        assert len(port_w.inversions()) == 1
    if scenario is _scenario_delta:
        assert ("store.py:169", "codec_sched.py:96") in port_w.edges
