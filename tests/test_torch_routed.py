"""The routed layout on the CPU: route_split against the whole shard, and
routed_tally / routed_pileup in gloo rank processes held against
bronko_tpu's make_routed_tally_scan / make_routed_pileup_scan (in this
process, on the 8 virtual CPU devices of conftest.py) and against the
port on one device, exactly.

Two panels: 4 strains (the int32 histogram word; pass 1 saves its probe
on a Dx1 mesh and routed_pileup walks it) and 13 strains (the multi-word
histogram). Meshes 2x1 and 2x2 at one batch and three, 4x1 at one; a
world of 2 ranks and one of 4, each started once for the module."""

import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bronko_tpu.index.layout import build_device_index as jax_device_index  # noqa: E402
from bronko_tpu.parallel import pipeline as jp  # noqa: E402
from bronko_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from bronko_tpu_torch.index.layout import KEY_SENTINEL, build_device_index  # noqa: E402
from bronko_tpu_torch.index.model import from_jax_index  # noqa: E402
from bronko_tpu_torch.index.store import save_index  # noqa: E402
from bronko_tpu_torch.ops import map as tm  # noqa: E402
from bronko_tpu_torch.parallel import distributed, pipeline  # noqa: E402
from bronko_tpu_torch.ops.codec import from_u64  # noqa: E402
from tests.test_map import make_index, random_genome, sample_kmers  # noqa: E402
from tests.test_torch_mesh import free_port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
RANK_TIMEOUT = 300
PANELS = {"hist": 4, "words": 13}
# (world, D, G, batches a sample)
CASES = [(2, 2, 1, 1), (2, 2, 1, 3), (4, 2, 2, 1), (4, 2, 2, 3), (4, 4, 1, 1)]

RANK = textwrap.dedent("""
    import json, os, sys
    sys.modules["jax"] = None          # a rank needs neither JAX
    sys.modules["bronko_tpu"] = None   # nor the JAX package
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from bronko_tpu_torch.index.layout import build_device_index
    from bronko_tpu_torch.index.store import load_index
    from bronko_tpu_torch.ops import map as tm
    from bronko_tpu_torch.ops.codec import from_u64
    from bronko_tpu_torch.parallel import pipeline
    from bronko_tpu_torch.parallel.distributed import init_distributed, shutdown
    from bronko_tpu_torch.parallel.mesh import make_mesh

    tmp, port, world, rank = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    cpu = torch.device("cpu")
    assert init_distributed(f"127.0.0.1:{port}", world, rank)
    report = {}
    for case in json.load(open(os.path.join(tmp, f"plan{world}.json"))):
        index = load_index(os.path.join(tmp, case["panel"] + ".bkdb"))
        dev = build_device_index(index, cpu)
        mcfg = dev.map_config(2, False)
        data = np.load(os.path.join(tmp, case["panel"] + "_kmers.npz"))
        D, G, B = case["D"], case["G"], case["batch"]
        mesh = make_mesh(D, G)
        sharded = pipeline.split_index(index, G)
        mode = sharded.tally_mode()
        chunks, bounds = pipeline.route_split(sharded, D)
        chunk = pipeline.upload_chunk(chunks, bounds, mesh.g, mesh.d, cpu)
        kmers, counts = data["kmers"], data["counts"]
        batches = [(from_u64(kmers[i:i + B][mesh.d::D], cpu),
                    torch.from_numpy(counts[i:i + B][mesh.d::D].astype(np.int32)))
                   for i in range(0, kmers.shape[0], B)]
        save = G == 1 and mode == "hist"
        out, saved, own = pipeline.routed_tally(batches, chunk, mcfg, mode, mesh, save)
        rep = dict(mode=mode)
        arrays = dict(tallies=out)
        if save:
            best = int(data["best"])
            postings = torch.from_numpy(sharded.shards[0].postings)
            walk = own[:, best].tolist()
            part = tm.pileup_from_saved(batches, saved, walk, postings, best, mcfg,
                                        dev.g_total_len, int(dev.file_bases[best]))
            rep.update(added=int(part[2:].sum()), walk=int(sum(walk)))
            arrays["pileup"] = pipeline.routed_pileup(
                batches, saved, own, postings, best, int(dev.file_bases[best]), mcfg,
                dev.g_total_len).numpy()
            for i, (start, h) in enumerate(saved):
                arrays[f"start{i}"], arrays[f"h{i}"] = start.numpy(), h.numpy()
        np.savez(os.path.join(tmp, f"{case['id']}.{rank}.npz"), **arrays)
        report[case["id"]] = rep
    with open(os.path.join(tmp, f"report{world}.{rank}.json"), "w") as fh:
        json.dump(report, fh)
    shutdown()
    print("RANK_OK")
""")


def strains(rng, n: int, length: int = 400, snps: int = 5):
    base = random_genome(rng, length)
    files = []
    for i in range(n):
        g = bytearray(base)
        for p in rng.integers(0, length, snps):
            g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1 + rng.integers(3)) % 4]
        files.append((f"g{i}", [(f"s{i}", bytes(g))]))
    return files


def case_id(panel: str, D: int, G: int, nb: int) -> str:
    return f"{panel}_{D}x{G}_nb{nb}"


def spawn(tmp: str, world: int) -> list[subprocess.Popen]:
    port = free_port()
    env = {**os.environ, "BRONKO_PLATFORM": "cpu", "PYTHONPATH": REPO}
    return [subprocess.Popen([sys.executable, "-c", RANK, tmp, str(port), str(world), str(r)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait_ranks(procs: list[subprocess.Popen]) -> None:
    """Each rank within its own RANK_TIMEOUT; a rank past it ends them all."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK_OK" in out, f"rank {r}:\n{out[-4000:]}"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The panels (JAX's index, saved for the ranks), their k-mers, the
    batch sizes of one and three batches, and both worlds' results."""
    tmp = str(tmp_path_factory.mktemp("torch_routed"))
    rng = np.random.default_rng(31)
    panels = {}
    for name, n in PANELS.items():
        files = strains(rng, n)
        jindex = make_index(tmp_path_factory.mktemp(name), files, 21)
        index = from_jax_index(jindex)
        save_index(os.path.join(tmp, name + ".bkdb"), index)
        pairs = sorted(sample_kmers(rng, files, 21, n_exact=300, n_mut=120, n_junk=30))
        kmers = np.asarray([p[0] for p in pairs], np.uint64)
        counts = np.asarray([p[1] for p in pairs], np.int32)
        best = n // 2
        np.savez(os.path.join(tmp, name + "_kmers.npz"), kmers=kmers, counts=counts, best=best)
        n_k = kmers.shape[0]
        batch = {1: -(-n_k // 4) * 4, 3: -(-(-(-n_k // 3)) // 4) * 4}
        assert -(-n_k // batch[3]) == 3
        panels[name] = dict(jindex=jindex, index=index, kmers=kmers, counts=counts, best=best,
                            batch=batch)
    for world in (2, 4):
        plan = [dict(id=case_id(name, D, G, nb), panel=name, D=D, G=G,
                     batch=panels[name]["batch"][nb])
                for w, D, G, nb in CASES if w == world for name in PANELS]
        with open(os.path.join(tmp, f"plan{world}.json"), "w") as fh:
            json.dump(plan, fh)
    running = [spawn(tmp, world) for world in (2, 4)]
    for procs in running:
        wait_ranks(procs)
    reports = {}
    for world in (2, 4):
        for r in range(world):
            with open(os.path.join(tmp, f"report{world}.{r}.json")) as fh:
                for cid, rep in json.load(fh).items():
                    reports.setdefault(cid, {})[r] = rep
    return tmp, panels, reports


def placed(p: dict, B: int, D: int):
    """JAX's placed batches: (nb, B) zero-padded, each deinterleaved so
    that device d's lanes are the batch's [d::D] (engine.place_batches)."""
    n = p["kmers"].shape[0]
    nb = -(-n // B)
    kb = np.zeros(nb * B, np.uint64)
    cb = np.zeros(nb * B, np.int32)
    kb[:n], cb[:n] = p["kmers"], p["counts"]
    kj = kb.reshape(nb, B // D, D).transpose(0, 2, 1).reshape(nb, B)
    cj = cb.reshape(nb, B // D, D).transpose(0, 2, 1).reshape(nb, B)
    return kj, cj


def single_device(p: dict, B: int):
    """The port on one device: tally_save's tallies, lanes and saved probe,
    and the pileup from it."""
    dev = build_device_index(p["index"], CPU)
    mcfg = dev.map_config(2, False)
    ct = torch.from_numpy(p["counts"])
    batches = list(zip(from_u64(p["kmers"], CPU).split(B), ct.split(B)))
    tallies, lanes, saved = tm.tally_save(batches, dev, mcfg)
    best = p["best"]
    pileup = tm.pileup_from_saved(batches, saved, lanes[:, best].tolist(), dev.pass2_postings(),
                                  best, mcfg, dev.g_total_len, int(dev.file_bases[best]))
    return tallies.numpy(), lanes.numpy(), saved, pileup.numpy()


ROUTED = [(name, D, G, nb) for _, D, G, nb in CASES for name in PANELS]


@pytest.mark.parametrize("name,D,G,nb", ROUTED, ids=[case_id(*c) for c in ROUTED])
def test_routed_tally_matches_jax_and_one_device(worlds, name, D, G, nb):
    """routed_tally's tallies and walk lengths equal the port's on one
    device and bronko_tpu's make_routed_tally_scan on the same mesh; with
    the saved probe, each rank's (start, h) equals JAX's for its lanes and
    the one-device probe's."""
    tmp, panels, reports = worlds
    p = panels[name]
    B = p["batch"][nb]
    cid = case_id(name, D, G, nb)
    got = {r: np.load(os.path.join(tmp, f"{cid}.{r}.npz")) for r in reports[cid]}
    tallies, lanes, saved1, _ = single_device(p, B)
    np.testing.assert_array_equal(got[0]["tallies"][:, :3], tallies)
    np.testing.assert_array_equal(got[0]["tallies"][:, 3], lanes.sum(axis=0))
    for r in got:
        np.testing.assert_array_equal(got[r]["tallies"], got[0]["tallies"])
    assert {rep["mode"] for rep in reports[cid].values()} == {name}

    jsh = jp.split_index(p["jindex"], G)
    mcfg = jsh.map_config(2, False)
    J = len(mcfg.positions)
    save = G == 1 and name == "hist"
    kj, cj = placed(p, B, D)
    step = jp.make_routed_tally_scan(jax_make_mesh(D, G), mcfg, name, (B // D) * J, save=save)
    out = step(jnp.asarray(kj), jnp.asarray(cj), *map(jnp.asarray, jp.route_split(jsh, D)))
    assert int(np.asarray(out[2])[0]) == 0
    np.testing.assert_array_equal(got[0]["tallies"][:, :3], np.asarray(out[0]))
    np.testing.assert_array_equal(np.asarray(out[1]), lanes.max(axis=0))
    if not save:
        return
    start_all, h_all = np.asarray(out[3]), np.asarray(out[4])
    Bl = B // D
    for i in range(kj.shape[0]):
        for r in range(D):
            start, h = got[r][f"start{i}"], got[r][f"h{i}"]
            n = h.shape[0]
            hit = h != 0
            np.testing.assert_array_equal(h, h_all[i, r * Bl:r * Bl + n])
            np.testing.assert_array_equal(start[hit], start_all[i, r * Bl:r * Bl + n][hit])
            s1, h1 = (t.numpy()[r::D] for t in saved1[i])
            np.testing.assert_array_equal(h, h1)
            np.testing.assert_array_equal(start[hit], s1[hit])
            assert (start[~hit] == 0).all()


SAVED = [(name, D, G, nb) for name, D, G, nb in ROUTED if G == 1 and name == "hist"]


@pytest.mark.parametrize("name,D,G,nb", SAVED, ids=[case_id(*c) for c in SAVED])
def test_routed_pileup_matches_jax_and_one_device(worlds, name, D, G, nb):
    """routed_pileup equals pileup_from_saved on one device and bronko_tpu's
    make_routed_pileup_scan fed JAX's own saved probe; on every rank the
    count planes add one a lane of its own walk, and the ranks' walks
    cover the sample's once."""
    tmp, panels, reports = worlds
    p = panels[name]
    B = p["batch"][nb]
    cid = case_id(name, D, G, nb)
    _, lanes, _, pileup1 = single_device(p, B)
    best = p["best"]
    ranks = reports[cid]
    for r, rep in ranks.items():
        assert rep["added"] == rep["walk"], r
        np.testing.assert_array_equal(np.load(os.path.join(tmp, f"{cid}.{r}.npz"))["pileup"],
                                      pileup1)
    assert sum(rep["walk"] for rep in ranks.values()) == int(lanes[:, best].sum()) > 0

    jsh = jp.split_index(p["jindex"], 1)
    mcfg = jsh.map_config(2, False)
    J = len(mcfg.positions)
    mesh = jax_make_mesh(D, 1)
    kj, cj = placed(p, B, D)
    kj, cj = jnp.asarray(kj), jnp.asarray(cj)
    routed = jp.route_split(jsh, D)
    out = jp.make_routed_tally_scan(mesh, mcfg, "hist", (B // D) * J, save=True)(
        kj, cj, *map(jnp.asarray, routed))
    jdev = jax_device_index(p["jindex"])
    gcfg = replace(mcfg, total_len=jdev.g_total_len, max_bucket=jdev.g_max_bucket,
                   lane_budget=int(lanes[:, best].max()) + 1)
    pileup, ov = jp.make_routed_pileup_scan(mesh, gcfg)(
        kj, cj, out[3], out[4], jnp.asarray(jsh.postings[0]),
        jnp.asarray([best], jnp.int32), jnp.asarray([int(jdev.file_bases[best])], jnp.int32))
    assert int(np.asarray(ov)[0]) == 0
    np.testing.assert_array_equal(np.asarray(pileup), pileup1)


def hand_sharded(rows: list[np.ndarray]) -> pipeline.ShardedIndex:
    """A ShardedIndex of one shard a key list (sorted uint64), one posting
    a row, the histogram word counting it for genome 0."""
    shards = []
    for keys in rows:
        u = keys.shape[0]
        shards.append(pipeline.Shard(keys=keys, offsets=np.arange(u + 1, dtype=np.int32),
                                     postings=np.arange(u, dtype=np.int64) << 22,
                                     hist=np.ones(u, np.int32), hist_words=None))
    return pipeline.ShardedIndex(k=21, shards=shards, shard_len=np.full(len(rows), 10),
                                 t_pad=10, num_genomes=1, max_bucket=1,
                                 shard_files=[[0]] + [[] for _ in rows[1:]], seq_slices=[],
                                 genome_lens=np.array([10]))


@pytest.mark.parametrize("D", [2, 4, 8])
def test_route_split_covers_each_shard(indexes_for_split, D):
    """Each shard's chunks hold its rows in order, D of ceil(U_s/D) rows
    (the trailing ones empty when U_s is short), with their global CSR
    starts and histogram rows; each chunk's bound is its first key; every
    key routes to the chunk that holds it: a real key 2^64-1 too, and in
    a shard of fewer rows than D."""
    for sharded in indexes_for_split:
        chunks, bounds = pipeline.route_split(sharded, D)
        assert bounds.shape == (len(sharded.shards), D) and bounds.dtype == np.uint64
        for s, shard in enumerate(sharded.shards):
            keys, offsets, hist = pipeline._own_rows(shard, sharded.tally_mode())
            U = keys.shape[0]
            sizes = [c.keys.shape[0] for c in chunks[s]]
            c = -(-U // D)
            assert sizes == [max(0, min(c, U - d * c)) for d in range(D)]
            np.testing.assert_array_equal(np.concatenate([c.keys for c in chunks[s]]), keys)
            np.testing.assert_array_equal(np.concatenate([c.hist for c in chunks[s]]), hist)
            np.testing.assert_array_equal(np.concatenate([c.starts for c in chunks[s]]),
                                          offsets[:-1])
            for d, ch in enumerate(chunks[s]):
                assert bounds[s, d] == (ch.keys[0] if ch.keys.shape[0] else KEY_SENTINEL)
            live = from_u64(pipeline.live_bounds(bounds[s], chunks[s]), CPU) ^ tm.SIGN_BIT
            dest = pipeline.route_dest(from_u64(keys, CPU), live).numpy()
            owner = np.repeat(np.arange(D), sizes)
            np.testing.assert_array_equal(dest, owner)


@pytest.fixture(scope="module")
def indexes_for_split(tmp_path_factory):
    """A real 4-strain panel on 1 and 2 shards (both histogram modes), and
    hand-made shards: one ending in a real key 2^64-1, one of 3 rows, one
    with no rows."""
    rng = np.random.default_rng(7)
    out = []
    for n, G in ((4, 1), (13, 2)):
        index = from_jax_index(make_index(tmp_path_factory.mktemp(f"split{n}"),
                                          strains(rng, n, length=150), 21))
        out.append(pipeline.split_index(index, G))
    top = np.sort(rng.integers(0, 1 << 63, 9, dtype=np.uint64) * np.uint64(2))
    out.append(hand_sharded([np.append(top, KEY_SENTINEL),
                             np.array([3, 1 << 40, KEY_SENTINEL - np.uint64(1)], np.uint64),
                             np.zeros(0, np.uint64)]))
    return out


def test_all_to_all_failure_exits_1(monkeypatch):
    """An all_to_all whose collective raises ends the run (exit 1) rather
    than leaving the ranks' sequences of collectives out of step."""
    def broken(*args, **kwargs):
        raise RuntimeError("peer went away")

    monkeypatch.setattr(distributed.dist, "all_to_all_single", broken)
    monkeypatch.setattr(distributed.dist, "get_backend", lambda group=None: "gloo")
    with pytest.raises(SystemExit) as exc:
        distributed.all_to_all(torch.arange(4), [2, 2], [1, 3])
    assert exc.value.code == 1
