"""The port's entry pair on the CPU, held against the JAX package's:
entry() against __graft_entry__.entry(); ops/map.map_batch against
bronko_tpu's on three panels and on an index that holds only the int64
global postings; sharded_map_step + merge_step (and sharded_tally_step)
in a world of 2 gloo ranks against make_sharded_map_step +
make_merge_step (and make_sharded_tally_step) on the virtual CPU devices
of conftest.py; dryrun_multichip(4) against JAX's, run in a subprocess of
its own meanwhile, and dryrun_multichip(2), which fails as JAX's does."""

import ast
import functools
import json
import os
import re
import subprocess
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from bronko_tpu.index.layout import build_device_index as jax_device_index  # noqa: E402
from bronko_tpu.ops.map import map_batch as jax_map_batch  # noqa: E402
from bronko_tpu.parallel import pipeline as jp  # noqa: E402
from bronko_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from bronko_tpu_torch import entry  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index, from_jax_arrays  # noqa: E402
from bronko_tpu_torch.index.model import from_jax_index  # noqa: E402
from bronko_tpu_torch.index.store import save_index  # noqa: E402
from bronko_tpu_torch.ops import map as tm  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64  # noqa: E402
from tests.test_map import make_index, random_genome, sample_kmers  # noqa: E402
from tests.test_torch_mesh import free_port  # noqa: E402
from tests.test_torch_routed import wait_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
JAX_TIMEOUT = 900
MESHES = ("2x1", "1x2")
BATCH = 256


JAX_DRYRUN = textwrap.dedent("""
    import __graft_entry__ as g
    g.dryrun_multichip(4)
""")
# the layouts of JAX's dryrun_multichip(2) on 8 virtual CPU devices, which
# its own routed check reports as it fails (AssertionError)
JAX_LAYOUTS_2 = {"dxg": {"batchwise"}, "batchwise": {"batchwise"}, "d1": {"batchwise"},
                 "pair_mesh": {"batchwise"}, "bsplit": {"bsplit"}}
ROUTED_NEVER = re.compile(r"routed layout never engaged in a single-batch mesh run: (\{.*\})")


@pytest.fixture(scope="module", autouse=True)
def jax_dryrun_4():
    """JAX's dryrun_multichip(4) in a process of its own with 8 virtual CPU
    devices, started with the module's first test, so that it runs while
    the others do."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.Popen([sys.executable, "-c", JAX_DRYRUN], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def jax_map(jindex, kmers, counts):
    """bronko_tpu's map_batch over the whole index, with a lane budget that
    holds every lane (asserted: no overflow)."""
    jdev = jax_device_index(jindex)
    cfg = jdev.map_config(2, False)
    cfg = replace(cfg, lane_budget=kmers.shape[0] * len(cfg.positions) * jdev.max_bucket)
    fn = jax.jit(functools.partial(jax_map_batch, cfg=cfg))
    pileup, tallies, overflow = fn(
        jnp.asarray(kmers), jnp.asarray(counts), jdev.keys, jdev.offsets, jdev.postings,
        jnp.zeros((4, jdev.total_len + 1, 4), jnp.int32),
        jnp.zeros((jdev.num_genomes, 3), jnp.int32))
    assert int(overflow) == 0
    return np.asarray(pileup), np.asarray(tallies)


def port_map(dev, kmers, counts):
    fn = functools.partial(tm.map_batch, cfg=dev.map_config(2, False))
    pileup, tallies = fn(
        from_u64(kmers, CPU), torch.from_numpy(counts), dev.keys_ordered, dev.offsets,
        dev.global_postings(),
        torch.zeros((4, dev.total_len + 1, 4), dtype=torch.int32),
        torch.zeros((dev.num_genomes, 3), dtype=torch.int32))
    return pileup.numpy(), tallies.numpy()


def test_entry_matches_the_jax_entry(monkeypatch):
    """entry()'s fn(*args) on the CPU equals __graft_entry__.entry()'s on the
    same panel and k-mers: the pileup over all genomes and the tallies;
    the port's index holds only the genome-local int32 postings, so the
    global ones are built from file_bases."""
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    fn, args = entry.entry()
    assert all(a.device == CPU for a in args)
    assert args[4].dtype == torch.int64
    pileup, tallies = fn(*args)
    jfn, jargs = graft.entry()
    jpileup, jtallies, overflow = jax.jit(jfn)(*jargs)
    assert int(overflow) == 0
    np.testing.assert_array_equal(np.asarray(args[0].numpy()).view(np.uint64),
                                  np.asarray(jargs[0]))
    np.testing.assert_array_equal(pileup.numpy(), np.asarray(jpileup))
    np.testing.assert_array_equal(tallies.numpy(), np.asarray(jtallies))
    assert int(tallies.sum()) > 0 and int(pileup[2:].sum()) > 0


def strains(rng, n: int, length: int = 900, snps: int = 8, tail: bytes = b""):
    base = random_genome(rng, length)
    files = []
    for i in range(n):
        g = bytearray(base)
        for p in rng.integers(50, length - 50, snps):
            g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1) % 4]
        files.append((f"g{i}", [(f"s{i}", bytes(g[:850]) + tail + bytes(g[850:]))]))
    return files


PANELS = {"hist": (4, b""), "words": (13, b""), "flat": (5, b"A" * 300)}


@pytest.mark.parametrize("name", [*PANELS, "int64_postings"])
def test_map_batch_matches_jax(tmp_path, name):
    """map_batch equals bronko_tpu's on test_torch_mesh.py's three panels
    (the int32 histogram word, the multi-word histogram, the flat tally),
    each with its genome-local int32 postings, and on an index carried
    across from JAX's arrays with only the int64 global postings."""
    n, tail = PANELS.get(name, (3, b""))
    rng = np.random.default_rng(sum(map(ord, name)))
    files = strains(rng, n, tail=tail)
    jindex = make_index(tmp_path, files, 21)
    pairs = sample_kmers(rng, files, 21, n_exact=300, n_mut=150, n_junk=20)
    kmers = np.asarray([p[0] for p in pairs], np.uint64)
    counts = np.asarray([p[1] for p in pairs], np.int32)
    if name == "int64_postings":
        jdev = jax_device_index(jindex)
        dev = from_jax_arrays(
            k=21, keys=np.asarray(jdev.keys), offsets=np.asarray(jdev.offsets), hist=None,
            postings_local32=None, postings=np.asarray(jdev.postings), fid_grouped=True,
            file_bases=jdev.file_bases, genome_lens=jdev.genome_lens,
            seq_slices=jdev.seq_slices, max_bucket=jdev.max_bucket,
            total_len=jdev.total_len, device=CPU)
        assert dev.postings_local32 is None and dev.global_postings() is dev.postings
    else:
        dev = build_device_index(from_jax_index(jindex), CPU)
        assert dev.postings_local32 is not None and dev.postings is None
        assert dev.tally_mode() == name
    pileup, tallies = port_map(dev, kmers, counts)
    jpileup, jtallies = jax_map(jindex, kmers, counts)
    np.testing.assert_array_equal(pileup, jpileup)
    np.testing.assert_array_equal(tallies, jtallies)
    assert int(tallies[:, 0].sum()) > 0


RANK = textwrap.dedent("""
    import json, os, sys
    sys.modules["jax"] = None
    sys.modules["bronko_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from bronko_tpu_torch.index.store import load_index
    from bronko_tpu_torch.ops.codec import from_u64
    from bronko_tpu_torch.ops.map import make_map_config
    from bronko_tpu_torch.parallel import pipeline
    from bronko_tpu_torch.parallel.distributed import init_distributed, shutdown
    from bronko_tpu_torch.parallel.mesh import make_mesh

    tmp, port, world, rank, B = (sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                                 int(sys.argv[5]))
    cpu = torch.device("cpu")
    assert init_distributed(f"127.0.0.1:{port}", world, rank)
    index = load_index(os.path.join(tmp, "panel.bkdb"))
    data = np.load(os.path.join(tmp, "kmers.npz"))
    for shape in json.loads(sys.argv[6]):
        D, G = (int(x) for x in shape.split("x"))
        mesh = make_mesh(D, G)
        sharded = pipeline.split_index(index, G)
        cfg = make_map_config(k=index.k, max_bucket=sharded.max_bucket,
                              num_genomes=sharded.num_genomes, total_len=sharded.t_pad,
                              n_fixed=2, use_full_kmer=False)
        shard = pipeline.upload_shard(sharded.shards[mesh.g], sharded.tally_mode(), cpu,
                                      postings=True)
        pileup = torch.zeros((4, sharded.t_pad + 1, 4), dtype=torch.int32)
        tallies = torch.zeros((sharded.num_genomes, 3), dtype=torch.int32)
        flat = torch.zeros_like(tallies)
        n = data["kmers"].shape[0]
        own = B // D
        for lo in range(0, n, B):
            kb = np.zeros(B, np.uint64)
            cb = np.zeros(B, np.int32)
            kb[:min(B, n - lo)] = data["kmers"][lo:lo + B]
            cb[:min(B, n - lo)] = data["counts"][lo:lo + B]
            km = from_u64(kb[mesh.d * own:(mesh.d + 1) * own], cpu)
            ct = torch.from_numpy(cb[mesh.d * own:(mesh.d + 1) * own])
            pileup, tallies = pipeline.sharded_map_step(km, ct, shard, pileup, tallies,
                                                        cfg=cfg, mesh=mesh)
            flat += pipeline.sharded_tally_step(km, ct, shard, cfg, mesh)
        pileup, tallies = pipeline.merge_step(pileup, tallies, mesh)
        np.savez(os.path.join(tmp, f"{shape}.{rank}.npz"), pileup=pileup.numpy(),
                 tallies=tallies.numpy(), flat=flat.numpy(), g=mesh.g)
    shutdown()
    print("RANK_OK")
""")


@pytest.fixture(scope="module")
def map_step_world(tmp_path_factory):
    """test_parallel.py's panel (5 genomes of 250-370 bp) and k-mers, the
    port's map step on meshes 2x1 and 1x2 in a world of 2 ranks."""
    tmp = tmp_path_factory.mktemp("torch_map_step")
    rng = np.random.default_rng(123)
    files = [(f"g{f}", [(f"s{f}_0", random_genome(rng, 250 + 30 * f))]) for f in range(5)]
    jindex = make_index(tmp, files, 21)
    save_index(str(tmp / "panel.bkdb"), from_jax_index(jindex))
    pairs = sample_kmers(rng, files, 21, n_exact=150, n_mut=80, n_junk=16)
    kmers = np.asarray([p[0] for p in pairs], np.uint64)
    counts = np.asarray([p[1] for p in pairs], np.int32)
    np.savez(tmp / "kmers.npz", kmers=kmers, counts=counts)
    port = free_port()
    env = {**os.environ, "BRONKO_PLATFORM": "cpu", "PYTHONPATH": REPO}
    wait_ranks([subprocess.Popen(
        [sys.executable, "-c", RANK, str(tmp), str(port), "2", str(r), str(BATCH),
         json.dumps(MESHES)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)])
    return str(tmp), jindex, kmers, counts


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_map_step_matches_jax(map_step_world, shape):
    """sharded_map_step over every batch, then merge_step: each genome
    shard's merged pileup and the tallies equal make_sharded_map_step +
    make_merge_step's on the same mesh (tests/test_parallel.py's run);
    sharded_tally_step's tallies equal make_sharded_tally_step's."""
    tmp, jindex, kmers, counts = map_step_world
    D, G = (int(x) for x in shape.split("x"))
    sharded = jp.split_index(jindex, G)
    mcfg = sharded.map_config(2, False)
    mesh = jax_make_mesh(D, G)
    step, merge = jp.make_sharded_map_step(mesh, mcfg), jp.make_merge_step(mesh)
    tally_step = jp.make_sharded_tally_step(mesh, replace(mcfg, lane_factor=64))
    T, NG = sharded.t_pad, sharded.num_genomes
    pileup = jnp.zeros((D, G, 4, T + 1, 4), jnp.int32)
    tallies = jnp.zeros((D, NG, 3), jnp.int32)
    flat = np.zeros((NG, 3), np.int64)
    shards = [jnp.asarray(a) for a in (sharded.keys, sharded.offsets, sharded.postings)]
    for lo in range(0, kmers.shape[0], BATCH):
        kb = np.zeros(BATCH, np.uint64)
        cb = np.zeros(BATCH, np.int32)
        kb[:len(kmers[lo:lo + BATCH])] = kmers[lo:lo + BATCH]
        cb[:len(counts[lo:lo + BATCH])] = counts[lo:lo + BATCH]
        pileup, tallies, overflow = step(jnp.asarray(kb), jnp.asarray(cb), *shards,
                                         pileup, tallies)
        assert int(np.asarray(overflow)[0]) == 0
        tl, ov = tally_step(jnp.asarray(kb), jnp.asarray(cb), *shards)
        assert int(np.asarray(ov)[0]) == 0
        flat += np.asarray(tl)
    mpileup, mtallies = merge(pileup, tallies)
    mpileup, mtallies = np.asarray(mpileup)[0], np.asarray(mtallies)[0]
    assert int(mtallies.sum()) > 0
    for r in range(D * G):
        got = np.load(os.path.join(tmp, f"{shape}.{r}.npz"))
        np.testing.assert_array_equal(got["tallies"], mtallies)
        np.testing.assert_array_equal(got["pileup"], mpileup[int(got["g"])])
        np.testing.assert_array_equal(got["flat"], flat)


def test_dryrun_multichip_4_equals_jax(jax_dryrun_4, monkeypatch, capsys):
    """dryrun_multichip(4) on the CPU (4 gloo ranks, a 2x2 mesh) prints
    JAX's dryrun_multichip(4) line exactly: the map step's and the tally
    step's sums, the engine's perfect k-mers, and each run's layouts,
    routed among them (d1)."""
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    line = entry.dryrun_multichip(4)
    assert capsys.readouterr().out.strip().splitlines()[-1] == line
    assert "d1=routed" in line and "bsplit=bsplit" in line
    try:
        out, _ = jax_dryrun_4.communicate(timeout=JAX_TIMEOUT)
    except subprocess.TimeoutExpired:
        jax_dryrun_4.kill()
        out, _ = jax_dryrun_4.communicate()
    assert jax_dryrun_4.returncode == 0, out[-4000:]
    (want,) = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip(4)")]
    assert line == want


def test_dryrun_multichip_2_fails_as_jax_does(monkeypatch, caplog):
    """At 2 devices the dry run's samples span 3 batches (JAX pads them to
    4), so every mesh run but the small panel's is batchwise and the check
    that the routed layout engaged fails; the port takes JAX's layout in
    every run and fails the same check (exit 1)."""
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    with pytest.raises(SystemExit) as exc:
        entry.dryrun_multichip(2)
    assert exc.value.code == 1
    got = ROUTED_NEVER.search(caplog.text)
    assert got, caplog.text[-2000:]
    assert ast.literal_eval(got.group(1)) == JAX_LAYOUTS_2
