"""The port's multi-device map steps (minigraph_tpu_torch/parallel/shard.py)
and the sweep's mesh= (index/midx_device.py, mapping/seeds.py) against
the JAX package's, on the CPU.

The port runs one process a rank on torch.distributed with gloo: world
size 2 as (data, idx) = (2, 1) and (1, 2) meshes, world size 4 as
(2, 2).  The JAX side runs the same five steps on virtual CPU meshes of
the same shapes in one subprocess (XLA_FLAGS
--xla_force_host_platform_device_count=4, JAX_PLATFORMS=cpu).  Both
run this file as a script (`worker` and `jax` modes) and leave .npz
files; the tests compare them.

Inputs: a 60 kb synthetic bubble graph (tools/synth.py) whose reference
holds one 1.5 kb block four times, and four reads padded to 1024: a
1 kb slice of the block (its ~1000 hits split over two key shards
exceed the per-shard cap acap_shard = max(acap // 2, 256) = 256, so
the idx-sharded steps truncate each shard before the merge), two reads
off the graph and an empty lane.  The port builds each join shard from
its real keymat columns (a padded column would read as key 0); no query
can carry key 0 at k = 17: the one k-mer whose hash is 0 is not
canonical (its reverse complement is smaller).  Tolerance: exact
equality."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
W, K = 11, 17
MCAP, ACAP, QCAP = 256, 512, 256
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
SHAPES = [s for w in MESHES for s in MESHES[w]]
STEPS = ("v1", "v2", "v2_idx", "hash_idx", "v1_idx")
BUCKETS = ((512, 8), (2048, 4))       # sweep buckets, rows split by 2
TIMEOUT = 300


def make_inputs(work: Path) -> None:
    from minigraph_tpu_torch.ops.sketch import encode_batch
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 simulate_reads,
                                                 write_bubble_rgfa)
    rng = np.random.default_rng(60)
    base = make_reference(60_000, seed=61)
    block = "".join("ACGT"[i] for i in rng.integers(0, 4, 1500))
    ref = "".join(base[i * 15000:(i + 1) * 15000] + block for i in range(4))
    hap = write_bubble_rgfa(ref, 62, str(work / "g.gfa"), seg_len=10_000)
    sim = [s for _, s in simulate_reads([hap], 2, seed=63, mean_len=800,
                                        min_len=600, max_len=1000)]
    reads = [block[200:1200]] + sim + [""]
    codes, lens = encode_batch(reads, pad_to=1024)
    # the sweep: a long sequence (several chunks of each bucket) and two
    # short ones
    seqs = [hap[1000:9000], hap[20000:20700], block]
    np.savez(work / "inputs.npz", codes=codes, lens=lens,
             seqs=np.array(seqs, dtype=object))


def load_inputs(work: Path):
    z = np.load(work / "inputs.npz", allow_pickle=True)
    return z["codes"], z["lens"], [str(s) for s in z["seqs"]]


def flat_records(res):
    """Per-sequence (x, y) record arrays -> one array with lengths."""
    if not res:
        return np.zeros(0, np.uint64)
    return np.concatenate([np.array([len(x)], np.uint64) for x, _ in res]
                          + [a for xy in res for a in xy])


# ---------------------------------------------------------------- workers
def torch_worker(work: Path, world: int, rank: int, port: int) -> None:
    import torch.distributed as dist

    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.index.midx_device import sketch_segments_device
    from minigraph_tpu_torch.mapping.seeds import collect_minimizers_device
    from minigraph_tpu_torch.ops.anchors import JoinIndex
    from minigraph_tpu_torch.ops.pipeline import DeviceIndex
    from minigraph_tpu_torch.parallel import shard

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        codes, lens, seqs = load_inputs(work)
        gi = build_index(read_gfa(str(work / "g.gfa")), K, W)
        dix = DeviceIndex.from_host(gi, "cpu")
        ji = JoinIndex.from_host(gi, 16, "cpu")
        out = {}
        try:
            shard.make_mesh(world + 1, device="cpu")
        except ValueError:
            out["mesh_size_error"] = np.array(1)
        for shape in MESHES[world]:
            mesh = shard.make_mesh(world, idx_shards=shape[1], device="cpu")
            tag = f"{shape[0]}x{shape[1]}"
            steps = {
                "v1": shard.make_sharded_map_step(mesh, dix, MCAP, ACAP),
                "v2": shard.make_sharded_map_step_v2(
                    mesh, ji, W, K, acap=ACAP, qcap=QCAP, window=16,
                    b_chunk=2),
                "v2_idx": shard.make_index_sharded_map_step_v2(
                    mesh, ji, W, K, acap=ACAP, qcap=QCAP),
                "hash_idx": shard.make_hash_sharded_map_step(
                    mesh, gi, acap=ACAP, qcap=QCAP, device="cpu"),
                "v1_idx": shard.make_index_sharded_map_step(
                    mesh, dix, MCAP, ACAP),
            }
            for name, step in steps.items():
                res = step(codes, lens)
                if isinstance(res, dict):
                    for key, v in res.items():
                        out[f"{tag}/{name}/{key}"] = v.numpy()
                else:
                    out[f"{tag}/{name}/best"] = res[0].numpy()
                    out[f"{tag}/{name}/n_anchors"] = res[1].numpy()
            if shape == (2, 1):
                out["sweep"] = flat_records(sketch_segments_device(
                    seqs, W, K, buckets=BUCKETS, device="cpu", mesh=mesh))
                qlens = [len(s) for s in seqs]
                x, y = collect_minimizers_device(gi, qlens, seqs, "cpu",
                                                 mesh=mesh)
                out["collect_x"], out["collect_y"] = x, y
        np.savez(work / f"torch_w{world}_r{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def jax_worker(work: Path, shape) -> None:
    import jax

    from minigraph_tpu.graph.gfa_io import read_gfa
    from minigraph_tpu.index.midx import build_index
    from minigraph_tpu.index.midx_device import sketch_segments_device
    from minigraph_tpu.ops.anchors_jax import JoinIndex
    from minigraph_tpu.ops.pipeline import DeviceIndex
    from minigraph_tpu.parallel import shard

    codes, lens, seqs = load_inputs(work)
    gi = build_index(read_gfa(str(work / "g.gfa")), K, W)
    dix = DeviceIndex.from_host(gi)
    ji = JoinIndex.from_host(gi, occ_cap=16)
    out = {}
    mesh = shard.make_mesh(shape[0] * shape[1], idx_shards=shape[1])
    tag = f"{shape[0]}x{shape[1]}"
    steps = {
        "v1": shard.make_sharded_map_step(mesh, dix, MCAP, ACAP),
        "v2": shard.make_sharded_map_step_v2(
            mesh, ji, W, K, acap=ACAP, qcap=QCAP, window=16, b_chunk=2),
        "v2_idx": shard.make_index_sharded_map_step_v2(
            mesh, ji, W, K, acap=ACAP, qcap=QCAP),
        "hash_idx": shard.make_hash_sharded_map_step(
            mesh, gi, acap=ACAP, qcap=QCAP),
        "v1_idx": shard.make_index_sharded_map_step(
            mesh, dix, MCAP, ACAP),
    }
    with mesh:
        for name, step in steps.items():
            res = jax.device_get(step(codes, lens))
            if isinstance(res, dict):
                for key, v in res.items():
                    out[f"{tag}/{name}/{key}"] = np.asarray(v)
            else:
                out[f"{tag}/{name}/best"] = np.asarray(res[0])
                out[f"{tag}/{name}/n_anchors"] = np.asarray(res[1])
    if shape == (2, 1):
        out["sweep"] = flat_records(sketch_segments_device(
            seqs, W, K, buckets=BUCKETS, mesh=mesh))
    np.savez(work / f"jax_{tag}.npz", **out)


# ---------------------------------------------------------------- tests
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**kw):
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("shard")
    make_inputs(work)
    me = str(Path(__file__).resolve())
    # one JAX process a mesh, each on one thread (the compiles dominate)
    procs = [subprocess.Popen(
        [sys.executable, me, "jax", str(work), str(d), str(i)],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                 "--xla_cpu_multi_thread_eigen=false"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for d, i in SHAPES]
    for world in MESHES:
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, me, "worker", str(work), str(world), str(r),
             str(port)], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ports = {(world, r): dict(np.load(work / f"torch_w{world}_r{r}.npz"))
             for world in MESHES for r in range(world)}
    want = {}
    for d, i in SHAPES:
        want.update(np.load(work / f"jax_{d}x{i}.npz"))
    return work, want, ports


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_jax(runs, shape, step):
    """Every output of the step, on every rank, equals the JAX sharded
    step's (global arrays, as JAX's out_specs give them)."""
    _, want, got = runs
    world = shape[0] * shape[1]
    prefix = f"{shape[0]}x{shape[1]}/{step}/"
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and keys == sorted(k for k in got[world, 0]
                                   if k.startswith(prefix))
    for r in range(world):
        for key in keys:
            a, b = want[key], got[world, r][key]
            assert a.shape == b.shape, (key, a.shape, b.shape)
            np.testing.assert_array_equal(a.astype(b.dtype), b,
                                          err_msg=f"rank {r} {key}")
    assert int(got[world, 0][prefix + "n_anchors"].max()) > 0


def test_acap_shard_binds(runs):
    """The block read's hits in one key shard pass acap_shard (256), so
    the idx-sharded v1 step truncates that shard before the merge."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.ops import u64
    from minigraph_tpu_torch.ops.pipeline import (DeviceIndex,
                                                  collect_anchors_device)
    from minigraph_tpu_torch.ops.sketch_v2 import sketch_device_v2
    from minigraph_tpu_torch.parallel.shard import shard_index_by_key
    work, _, got = runs
    codes, lens, _ = load_inputs(work)
    dix = DeviceIndex.from_host(build_index(read_gfa(str(work / "g.gfa")),
                                            K, W), "cpu")
    sh = shard_index_by_key(u64.to_numpy(dix.keys), dix.key_start.numpy(),
                            dix.key_cnt.numpy(), u64.to_numpy(dix.pos), 2)
    mx, my, n_mv = sketch_device_v2(torch.from_numpy(codes),
                                    torch.from_numpy(lens), W, K, MCAP)
    n_tot = [int(collect_anchors_device(
        u64.from_numpy(sh[0][s], "cpu"), torch.from_numpy(sh[1][s]),
        torch.from_numpy(sh[2][s]), u64.from_numpy(sh[3][s], "cpu"),
        dix.seg_len, mx, my, n_mv, 50, 16, 4096)[2][0]) for s in range(2)]
    assert max(n_tot) > max(ACAP // 2, 256), n_tot
    # n sums the capped shards' counts
    n_idx = got[2, 0]["1x2/v1_idx/n_anchors"]
    assert n_idx[0] == min(sum(min(n, 256) for n in n_tot), ACAP)


def test_sweep_mesh_matches(runs):
    """sketch_segments_device and collect_minimizers_device with a data-2
    mesh equal mesh=None, the JAX sweep on a data-2 mesh and the host
    sketch."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.index.midx_device import sketch_segments_device
    from minigraph_tpu_torch.mapping.seeds import collect_minimizers
    work, want, got = runs
    _, _, seqs = load_inputs(work)
    single = flat_records(sketch_segments_device(seqs, W, K, buckets=BUCKETS,
                                                 device="cpu"))
    np.testing.assert_array_equal(want["sweep"], single)
    gi = build_index(read_gfa(str(work / "g.gfa")), K, W)
    hx, hy = collect_minimizers(gi, [len(s) for s in seqs], seqs)
    for world in MESHES:
        for r in range(world):
            if "sweep" not in got[world, r]:
                continue
            np.testing.assert_array_equal(got[world, r]["sweep"], single)
            np.testing.assert_array_equal(got[world, r]["collect_x"], hx)
            np.testing.assert_array_equal(got[world, r]["collect_y"], hy)


def test_make_mesh_checks(runs):
    """A world size other than the mesh's is an error, and so is a mesh
    without a process group."""
    from minigraph_tpu_torch.parallel.shard import make_mesh
    _, _, got = runs
    assert all("mesh_size_error" in got[key] for key in got)
    with pytest.raises(RuntimeError):
        make_mesh(1, device="cpu")


def test_shard_tables_match_jax():
    """shard_index_by_key and the per-shard cuckoo tables of
    shard_hash_index against the JAX package's (its stacked, padded
    arrays), at 3 shards."""
    import minigraph_tpu.parallel.shard as jshard
    from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
    from minigraph_tpu.index.midx import build_index as jax_build_index
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.parallel import shard
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 write_bubble_rgfa)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "g.gfa")
        write_bubble_rgfa(make_reference(40_000, seed=64), 65, path,
                          seg_len=8000)
        jgi = jax_build_index(jax_read_gfa(path), K, W)
        gi = build_index(read_gfa(path), K, W)
    args = [np.asarray(getattr(gi, a)) for a in
            ("keys", "key_start", "key_cnt", "pos")]
    for a, b in zip(jshard.shard_index_by_key(*args, 3),
                    shard.shard_index_by_key(*args, 3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jt = jshard.shard_hash_index(jgi, 3)
    tables, hbits = shard.shard_hash_index(gi, 3, device="cpu")
    assert hbits == jt[4]
    for name, stacked in zip(("tag", "pay", "p_rid", "p_sel"), jt[:4]):
        stacked = np.asarray(stacked)
        for s, t in enumerate(tables):
            v = getattr(t, name).numpy()
            np.testing.assert_array_equal(stacked[s, :len(v)], v)
            assert not stacked[s, len(v):].any()


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_worker(Path(sys.argv[2]), tuple(map(int, sys.argv[3:5])))
    else:
        torch_worker(Path(sys.argv[2]), *map(int, sys.argv[3:6]))
