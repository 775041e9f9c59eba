"""The port's storage backends (npz, packed ``.gmpk``, memory) held against
the reference package's on the conftest RMAT store (scale 9).

* Every backend x cache mode {0, adaptive} x prefetch depth {0, 2}:
  pagerank/sssp/bfs/cc in the port equal the reference on the same backend
  and settings — BFS/SSSP/CC bitwise with every ``IterationStats`` field
  but the seconds equal, PageRank within ``PR_RTOL`` (the rule and its
  derivation are in ``tests/test_torch_session.py``).
* ``pack_graph`` of both packages writes identical bytes, and each package
  opens the other's file.
* ``read_shard_bytes`` is the canonical npz blob on every backend; memory
  loaded from a packed file owns its arrays; the CLI packs; ``close()``
  releases the mmap; the error cases raise what the reference raises.
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.graph import packed as jpacked
from repro.graph.memory import MemoryGraphStore as RefMemoryStore
from repro.graph.packed import PackedGraphStore as RefPackedStore
from repro.graph.source import MissingGraphError as RefMissingGraphError
from repro.session import GraphSession as RefSession
from repro_torch.graph.memory import MemoryGraphStore
from repro_torch.graph.packed import (PackedGraphStore, is_packed_file,
                                      pack_graph)
from repro_torch.graph.source import (MissingGraphError, ShardSource,
                                      unpack_shard_npz)
from repro_torch.graph.storage import GraphStore
from repro_torch.session import GraphSession
from tests.test_torch_session import EXACT_FIELDS, PR_RTOL, RUNS

REPO = Path(__file__).resolve().parent.parent
BACKENDS = ("npz", "packed", "memory")


@pytest.fixture(scope="module")
def store_dir(graph_store, tmp_path_factory):
    """A private copy of the conftest store (the packed file is written
    next to it, where the session's auto-pack looks for it)."""
    d = tmp_path_factory.mktemp("backends") / "store"
    shutil.copytree(graph_store.path, d)
    return d


@pytest.fixture(scope="module")
def packed_file(store_dir):
    return pack_graph(GraphStore(store_dir))  # <store>/packed.gmpk


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("cache_mode", [0, "auto"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("app", list(RUNS))
def test_backend_matches_reference(store_dir, packed_file, app, backend,
                                   cache_mode, prefetch):
    kw = dict(backend=backend, cache_mode=cache_mode,
              prefetch_depth=prefetch, cache_budget_bytes=1 << 20)
    with RefSession(str(store_dir), **kw) as s:
        want = s.run(app, **RUNS[app])
        want_disk = s.stats.disk_bytes
    with GraphSession(str(store_dir), device="cpu", **kw) as s:
        got = s.run(app, **RUNS[app])
        assert s.stats.disk_bytes == want_disk
    assert (got.iterations, got.converged, got.tag) == \
        (want.iterations, want.converged, want.tag)
    if app == "pagerank":
        np.testing.assert_allclose(got.values, want.values, rtol=PR_RTOL)
        return
    np.testing.assert_array_equal(got.values, want.values)
    for g, w in zip(got.history, want.history):
        for field in EXACT_FIELDS:
            assert getattr(g, field) == getattr(w, field), field


def test_pack_graph_bytes_match_reference(store_dir, packed_file, tmp_path):
    ref_file = jpacked.pack_graph(str(store_dir), tmp_path / "ref.gmpk")
    assert Path(packed_file).read_bytes() == Path(ref_file).read_bytes()
    # each package opens the other's file
    theirs, mine = PackedGraphStore(ref_file), RefPackedStore(packed_file)
    for p in range(theirs.num_shards):
        assert theirs.read_shard_bytes(p) == mine.read_shard_bytes(p)
    assert theirs.properties == mine.properties
    theirs.close()
    mine.close()


def test_every_backend_satisfies_the_protocol(store_dir, packed_file):
    npz = GraphStore(store_dir)
    for s in (npz, PackedGraphStore(packed_file),
              MemoryGraphStore.from_source(npz)):
        assert isinstance(s, ShardSource)
        assert s.num_shards == npz.num_shards
        assert s.total_shard_bytes() == npz.total_shard_bytes()


def test_backend_sniffing_and_auto_repack(store_dir, packed_file, tmp_path):
    assert is_packed_file(packed_file) and not is_packed_file(store_dir)
    with GraphSession(str(packed_file), device="cpu") as s:
        assert isinstance(s.store, PackedGraphStore)
    with GraphSession(str(store_dir), device="cpu") as s:
        assert isinstance(s.store, GraphStore)
    # a directory with no packed file is packed on first use, and packed
    # again once its property.json is newer than the file
    d = tmp_path / "fresh"
    shutil.copytree(store_dir, d, ignore=shutil.ignore_patterns("*.gmpk"))
    with GraphSession(str(d), backend="packed", device="cpu") as s:
        assert Path(s.store.path) == d / "packed.gmpk"
    first = (d / "packed.gmpk").stat().st_mtime_ns
    (d / "property.json").touch()
    with GraphSession(str(d), backend="packed", device="cpu"):
        pass
    assert (d / "packed.gmpk").stat().st_mtime_ns > first
    # memory from a packed file or from a directory
    for path in (packed_file, store_dir):
        with GraphSession(str(path), backend="memory", device="cpu") as s:
            assert isinstance(s.store, MemoryGraphStore)


def test_packed_round_trip_and_zero_copy(store_dir, packed_file):
    npz, packed = GraphStore(store_dir), PackedGraphStore(packed_file)
    for a, b in zip(packed.read_vertex_info(), npz.read_vertex_info()):
        np.testing.assert_array_equal(a, b)
    for p in range(npz.num_shards):
        got, want = packed.read_shard(p), npz.read_shard(p)
        for name in ("cols", "vals", "row_map"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
            view = getattr(got, name)
            assert not view.flags.owndata and not view.flags.writeable
        assert packed.shard_nbytes(p) == npz.shard_nbytes(p)
        np.testing.assert_array_equal(packed.read_bloom(p).bits,
                                      npz.read_bloom(p).bits)


def test_read_shard_bytes_is_canonical_across_backends(store_dir,
                                                       packed_file):
    npz = GraphStore(store_dir)
    ref = RefMemoryStore.from_source(RefPackedStore(packed_file))
    stores = (npz, PackedGraphStore(packed_file),
              MemoryGraphStore.from_source(npz))
    for p in range(npz.num_shards):
        want = npz.read_shard_bytes(p)
        assert ref.read_shard_bytes(p) == want
        for s in stores:
            assert s.read_shard_bytes(p) == want
            np.testing.assert_array_equal(
                unpack_shard_npz(p, s.read_shard_bytes(p)).cols,
                npz.read_shard(p).cols)


def test_memory_from_packed_owns_its_arrays(packed_file):
    mem = MemoryGraphStore.from_source(PackedGraphStore(packed_file))
    shard = mem.read_shard(0)
    for arr in (shard.cols, shard.vals, shard.row_map):
        assert arr.flags.owndata and arr.flags.writeable
    before = mem.io.read
    mem.read_shard(1)
    assert mem.io.read - before == mem.shard_nbytes(1)


def test_pack_cli(store_dir, tmp_path):
    out = tmp_path / "cli.gmpk"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.graph.pack", str(store_dir),
         str(out)], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert "packed" in r.stdout and out.is_file()
    assert PackedGraphStore(out).num_shards == GraphStore(store_dir).num_shards


@pytest.mark.parametrize("preload", [False, True])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_session_close_releases_packed_mmap(packed_file, prefetch, preload):
    """Unlike the reference's (where jax may alias the mapping), a closed
    port session leaves nothing that pins it: staged tensors and preloaded
    shards own their memory."""
    idle = GraphSession(str(packed_file), device="cpu", cache_mode=0)
    idle.close()
    assert idle.store._mm.closed
    with GraphSession(str(packed_file), device="cpu", cache_mode=1,
                      prefetch_depth=prefetch, preload=preload) as ran:
        ran.run("pagerank", max_iters=2)
        ran.run("sssp", source=0)
    assert ran.store._mm.closed


# the error cases: each package raises the same class with the same words
SESSIONS = [pytest.param(RefSession, {}, RefMissingGraphError,
                         id="reference"),
            pytest.param(GraphSession, {"device": "cpu"}, MissingGraphError,
                         id="port")]


@pytest.mark.parametrize("cls,kw,error", SESSIONS)
@pytest.mark.parametrize("backend", [None, "packed", "memory"])
def test_missing_graph_dir_raises_clear_error(tmp_path, cls, kw, error,
                                              backend):
    with pytest.raises(error, match="preprocess_graph|pack"):
        cls(str(tmp_path / "never_preprocessed"), backend=backend, **kw)


@pytest.mark.parametrize("cls,kw,error", SESSIONS)
@pytest.mark.parametrize("text,match", [("{ not json", "re-run"),
                                        ('{"num_vertices": 4}', "num_shards")])
def test_bad_property_json_raises_clear_error(tmp_path, text, match, cls,
                                              kw, error):
    d = tmp_path / "halfwritten"
    d.mkdir()
    (d / "property.json").write_text(text)
    with pytest.raises(MissingGraphError, match=match):
        GraphStore(d).properties
    with pytest.raises(error, match=match):
        cls(str(d), **kw)


def test_packed_rejects_non_packed_files(tmp_path, packed_file):
    bogus = tmp_path / "bogus.gmpk"
    bogus.write_bytes(b"not a packed graph at all")
    with pytest.raises(MissingGraphError, match="bad magic"):
        PackedGraphStore(bogus)
    with pytest.raises(MissingGraphError, match="packed graph file"):
        PackedGraphStore(tmp_path / "absent.gmpk")
    truncated = tmp_path / "truncated.gmpk"
    truncated.write_bytes(Path(packed_file).read_bytes()[:1024])
    with pytest.raises(MissingGraphError, match="corrupt or truncated"):
        PackedGraphStore(truncated)


@pytest.mark.parametrize("cls,kw,error", SESSIONS)
def test_unknown_backend_and_store_object(store_dir, cls, kw, error):
    with pytest.raises(ValueError, match="unknown backend"):
        cls(str(store_dir), backend="tape", **kw)
    with pytest.raises(TypeError, match="backend="):
        cls(GraphStore(store_dir), backend="npz", **kw)


def test_store_object_passes_through(store_dir):
    store = GraphStore(store_dir)
    with GraphSession(store, device="cpu") as s:
        assert s.store is store
