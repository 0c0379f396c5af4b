"""`--mesh DxG` on the CPU: ranks in separate processes joined over gloo
(the three flags), held against bronko_tpu's ShardedMapper and run_call
with the same mesh (in this process, on the 8 virtual CPU devices of
conftest.py) and against the port on one device.

Three panels, one a histogram regime: 4 strains (the single int32 word),
13 strains (the multi-word histogram), 5 strains with a poly-A stretch (a
bucket of more than 255 postings: the flat tally). Worlds of 2 ranks run
meshes 1x2 and 2x1, a world of 4 runs 2x2 and 4x1, each world once for
the whole module, at two batch sizes: one batch a sample (routed at D > 1
with a histogram, else B-split) and two (batchwise at D = 2, routed or
B-split at D = 4). Each run takes the layout JAX's ShardedMapper takes
for it. The ranks block jax and bronko_tpu."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bronko_tpu.call.engine as je  # noqa: E402
import bronko_tpu.config as jax_config  # noqa: E402
import bronko_tpu.index.build as jax_build  # noqa: E402
import bronko_tpu.index.layout as jax_layout  # noqa: E402
from bronko_tpu_torch.call import engine  # noqa: E402
from bronko_tpu_torch.config import CallConfig  # noqa: E402
from bronko_tpu_torch.index.build import build_index  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.index.store import save_index  # noqa: E402
from bronko_tpu_torch.io import native  # noqa: E402
from bronko_tpu_torch.ops import map as tm  # noqa: E402
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
PANELS = {"hist": (4, b""), "words": (13, b""), "flat": (5, b"A" * 300)}
MESHES = {2: ("1x2", "2x1"), 4: ("2x2", "4x1")}
RANK_TIMEOUT = 300

RANK = textwrap.dedent("""
    import json, os, sys
    sys.modules["jax"] = None          # a rank needs neither JAX
    sys.modules["bronko_tpu"] = None   # nor the JAX package
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from bronko_tpu_torch import cli
    from bronko_tpu_torch.call import engine
    from bronko_tpu_torch.config import CallConfig
    from bronko_tpu_torch.index.layout import build_device_index
    from bronko_tpu_torch.index.store import load_index
    from bronko_tpu_torch.ops import map as tm
    from bronko_tpu_torch.parallel.distributed import init_distributed, shutdown

    tmp, port, world, rank = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    cpu = torch.device("cpu")
    assert init_distributed(f"127.0.0.1:{port}", world, rank)
    plan = json.load(open(os.path.join(tmp, f"plan{world}.json")))
    report = {}
    for case in plan["passes"]:
        index = load_index(os.path.join(tmp, case["panel"] + ".bkdb"))
        dev = build_device_index(index, cpu)
        data = np.load(os.path.join(tmp, case["panel"] + "_kmers.npz"))
        mcfg = dev.map_config(2, False)
        mapper = engine.ShardedMapper(index, CallConfig(db="x", mesh=case["mesh"]), dev, cpu)
        batches = mapper.place_batches(data["kmers"], data["counts"], case["batch"])
        p1 = mapper.run_tallies(batches, mcfg)
        best = int(data["best"])
        pileup = mapper.run_pileup(batches, mcfg, best, dev.g_total_len)
        # this rank's own pass-2 share: one count-plane add a lane of its
        # exact walk, which pass 1 on one device counts for the same k-mers
        own = mapper.pass2_share(batches)
        part = tm.pileup_from_subindex(own, dev.subindex(best), None, mcfg, dev.g_total_len)
        _, lanes = tm.tally(own, dev, mcfg, "flat")
        report[case["id"]] = dict(added=int(part[2:].sum()), walk=int(lanes[:, best].sum()),
                                  layouts=sorted(mapper.layouts_used), path=list(p1.path))
        if rank == 0:
            np.savez(os.path.join(tmp, case["id"] + ".npz"), tallies=p1.tallies,
                     lanes=p1.lanes, pileup=pileup.numpy())
        mapper.close()
    for case in plan["engine"]:
        cfg = CallConfig(genomes=case["genomes"], reads=[case["fq"]],
                         first_pairs=[case["r1"]], second_pairs=[case["r2"]],
                         output=os.path.join(tmp, case["id"]), output_pileup=True,
                         mesh=case["mesh"], batch_size=case["batch"])
        results = cli.run_call_cmd(cfg, device=cpu)
        report[case["id"]] = dict(layouts=sorted(engine.LAST_MESH_LAYOUTS),
                                  best=[r.best for r in results],
                                  path=[list(r.path) for r in results])
    with open(os.path.join(tmp, f"report{world}.{rank}.json"), "w") as fh:
        json.dump(report, fh)
    shutdown()
    print("RANK_OK")
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(tmp: str, world: int) -> list[subprocess.Popen]:
    port = free_port()
    env = {**os.environ, "BRONKO_PLATFORM": "cpu", "PYTHONPATH": REPO}
    return [subprocess.Popen([sys.executable, "-c", RANK, tmp, str(port), str(world), str(r)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def finish(procs: list[subprocess.Popen]) -> None:
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


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The panels, their samples (single-end and a pair of mates), the
    plans of both worlds, and the ranks' reports once they have run."""
    tmp = str(tmp_path_factory.mktemp("torch_mesh"))
    native.get_lib()  # built once here, before the ranks load it
    rng = np.random.default_rng(23)
    base = make_genome(rng, 900)
    panels = {}
    for name, (n, tail) in PANELS.items():
        genomes = []
        for i in range(n):
            g = bytearray(base)
            for p in rng.integers(50, 850, 8):
                g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1) % 4]
            g[850:850] = tail
            genomes.append(os.path.join(tmp, f"{name}_{i}.fasta"))
            write_fasta(genomes[-1], f"{name}_{i}", bytes(g))
        truth = open(genomes[n // 2]).read().split("\n", 1)[1].replace("\n", "").encode()
        reads, _ = make_sample(truth, rng, read_len=80, depth=120,
                               major_positions={300: 0.95, 700: 0.9}, error_rate=0.002)
        fq, r1, r2 = (os.path.join(tmp, f"{name}{s}.fastq.gz") for s in ("", "_1", "_2"))
        write_fastq(fq, reads)
        write_fastq(r1, reads[::2])
        write_fastq(r2, reads[1::2])
        index = build_index(21, genomes)
        save_index(os.path.join(tmp, name + ".bkdb"), index)
        cfg = CallConfig(genomes=genomes, chunk_reads=8192)
        kmers, counts, _ = engine.count_sample(fq, cfg, 21, CPU)
        n_pair = sum(engine.count_sample(p, cfg, 21, CPU)[0].shape[0] for p in (r1, r2))
        np.savez(os.path.join(tmp, name + "_kmers.npz"), kmers=kmers, counts=counts,
                 best=n // 2)
        # one batch a sample; two batches of the single-end sample
        batch = {"bsplit": round_up(max(kmers.shape[0], n_pair), 4),
                 "batchwise": round_up(-(-kmers.shape[0] // 2), 4)}
        panels[name] = dict(genomes=genomes, fq=fq, r1=r1, r2=r2, best=n // 2,
                            kmers=kmers, counts=counts, batch=batch)
    for world, meshes in MESHES.items():
        plan = {"passes": [], "engine": []}
        for mesh in meshes:
            for name, p in panels.items():
                for layout, batch in p["batch"].items():
                    plan["passes"].append(dict(id=f"pass_{name}_{mesh}_{layout}", panel=name,
                                               mesh=mesh, batch=batch))
                plan["engine"].append(dict(
                    id=f"call_{name}_{mesh}_bsplit", mesh=mesh, batch=p["batch"]["bsplit"],
                    **{k: p[k] for k in ("genomes", "fq", "r1", "r2")}))
            p = panels["hist"]
            plan["engine"].append(dict(
                id=f"call_hist_{mesh}_batchwise", mesh=mesh, batch=p["batch"]["batchwise"],
                **{k: p[k] for k in ("genomes", "fq", "r1", "r2")}))
        with open(os.path.join(tmp, f"plan{world}.json"), "w") as fh:
            json.dump(plan, fh)
    running = [launch(tmp, world) for world in MESHES]
    for procs in running:
        finish(procs)
    reports = {}
    for world in MESHES:
        for r in range(world):
            with open(os.path.join(tmp, f"report{world}.{r}.json")) as fh:
                for case, rep in json.load(fh).items():
                    reports.setdefault(case, []).append(rep)
    return tmp, panels, reports


def single_device(p: dict, batch: int):
    """The port's passes on one device: (tallies, lanes, pileup of the
    selected genome)."""
    index = build_index(21, p["genomes"])
    dev = build_device_index(index, CPU)
    mcfg = dev.map_config(2, False)
    batches = engine.to_batches(p["kmers"], p["counts"], batch, CPU)
    tallies, lanes = tm.tally(batches, dev, mcfg, dev.tally_mode())
    walk = lanes[:, p["best"]].tolist()
    pileup = tm.pileup_from_subindex(batches, dev.subindex(p["best"]), walk, mcfg,
                                     dev.g_total_len)
    return tallies.numpy(), lanes.numpy(), pileup.numpy()


def jax_tallies(p: dict, mesh: str, batch: int):
    """bronko_tpu's ShardedMapper.run_tallies on the same mesh, and the
    layouts it used."""
    index = jax_build.build_index(21, p["genomes"])
    cfg = jax_config.CallConfig(genomes=p["genomes"], mesh=mesh, batch_size=batch)
    mapper = je.ShardedMapper(index, cfg, jax_layout.build_device_index(index))
    kb, cb = je._prepare_batches(p["kmers"], p["counts"], batch, upload=False,
                                 multiple=mapper.n_devices)
    return mapper.run_tallies(*mapper.place_batches(kb, cb)), mapper.layouts_used


CASES = [(name, mesh, layout) for meshes in MESHES.values() for mesh in meshes
         for name in PANELS for layout in ("bsplit", "batchwise")]


@pytest.mark.parametrize("name,mesh,layout", CASES,
                         ids=["-".join(c) for c in CASES])
def test_sharded_passes(worlds, name, mesh, layout):
    """Pass 1 over the mesh equals bronko_tpu's ShardedMapper on the same
    mesh and the port on one device, and its walk lengths the selected
    genome's; pass 2 equals the single-device pileup; on every rank the
    count planes add one a lane of its own exact walk, and the ranks'
    walks cover the sample's once."""
    tmp, panels, reports = worlds
    p = panels[name]
    batch = p["batch"][layout]
    got = np.load(os.path.join(tmp, f"pass_{name}_{mesh}_{layout}.npz"))
    tallies, lanes, pileup = single_device(p, batch)
    np.testing.assert_array_equal(got["tallies"], tallies)
    np.testing.assert_array_equal(got["lanes"], lanes.sum(axis=0, keepdims=True))
    np.testing.assert_array_equal(got["pileup"], pileup)
    assert int(got["pileup"][2:].sum()) == int(lanes[:, p["best"]].sum()) > 0
    want, jax_layouts = jax_tallies(p, mesh, batch)
    np.testing.assert_array_equal(got["tallies"], want)
    ranks = reports[f"pass_{name}_{mesh}_{layout}"]
    assert all(r["added"] == r["walk"] for r in ranks)
    assert sum(r["walk"] for r in ranks) == int(lanes[:, p["best"]].sum())
    # the layout JAX's ShardedMapper takes for the same batches; a routed
    # pass 1 on a Dx1 mesh with the histogram word saves its probe
    assert {tuple(r["layouts"]) for r in ranks} == {tuple(sorted(jax_layouts))}
    routed = jax_layouts == {"routed"}
    assert routed == (not mesh.startswith("1x") and name != "flat"
                      and (layout == "bsplit" or mesh == "4x1"))
    saved = routed and mesh.endswith("x1") and name == "hist"
    assert {tuple(r["path"]) for r in ranks} == {(name, "saved" if saved else "subindex")}


def outputs(out: str) -> dict[str, bytes]:
    return {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}


ENGINE = [(name, mesh, "bsplit") for meshes in MESHES.values() for mesh in meshes
          for name in PANELS] + [("hist", mesh, "batchwise")
                                 for meshes in MESHES.values() for mesh in meshes]


@pytest.mark.parametrize("name,mesh,layout", ENGINE, ids=["-".join(c) for c in ENGINE])
def test_call_matches_jax_and_one_device(worlds, name, mesh, layout):
    """`call --mesh --pileup` on a single-end sample and a pair of mates:
    rank 0's VCF, pileup TSV and overview equal bronko_tpu's run_call with
    the same mesh and the port's on one device, byte for byte; every rank
    selected the same genome; the layouts equal JAX's run's."""
    tmp, panels, reports = worlds
    p = panels[name]
    batch = p["batch"][layout]
    got = outputs(os.path.join(tmp, f"call_{name}_{mesh}_{layout}"))
    assert len(got) == 5  # two VCFs, two pileup TSVs, the overview
    kw = dict(genomes=p["genomes"], reads=[p["fq"]], first_pairs=[p["r1"]],
              second_pairs=[p["r2"]], output_pileup=True, batch_size=batch)
    out = os.path.join(tmp, f"single_{name}_{mesh}_{layout}")
    index = build_index(21, p["genomes"])
    engine.run_call(CallConfig(output=out, **kw), index, build_device_index(index, CPU))
    assert got == outputs(out)
    jout = os.path.join(tmp, f"jax_{name}_{mesh}_{layout}")
    jindex = jax_build.build_index(21, p["genomes"])
    je.run_call(jax_config.CallConfig(output=jout, mesh=mesh, **kw), jindex,
                jax_layout.build_device_index(jindex))
    assert got == outputs(jout)
    jax_layouts = tuple(sorted(je.LAST_MESH_LAYOUTS))
    vcf = got[os.path.basename(p["fq"]).split(".")[0] + ".vcf"].decode()
    assert {"301", "701"} <= {f[1] for f in (ln.split("\t") for ln in vcf.splitlines()
                                             if ln and not ln.startswith("#")) if f[6] == "PASS"}
    ranks = reports[f"call_{name}_{mesh}_{layout}"]
    assert {tuple(r["best"]) for r in ranks} == {(p["best"], p["best"])}
    (layouts,) = {tuple(r["layouts"]) for r in ranks}
    assert layouts == jax_layouts
    if mesh.startswith("1x"):
        assert layouts == ("batchwise",)
    elif layout == "bsplit":  # every sample one batch: JAX routes it with a histogram
        assert layouts == (("bsplit",) if name == "flat" else ("routed",))
    elif mesh == "2x1" or mesh == "2x2":  # the single-end sample in two batches
        assert "batchwise" in layouts
