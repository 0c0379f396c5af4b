"""`python -m bronko_tpu_torch call` across processes on the CPU (gloo),
after tests/test_distributed.py: two ranks joined by the three flags run
`--mesh 2x1`, and two by torchrun run `--mesh 1x2`, each byte-identical to
one process and to bronko_tpu with the same mesh; `--shard-samples` over
4 samples and a failing file on 2 ranks, byte-identical to one process
and exit 2 on both; `--mesh 1x1` in one process on a world of its own;
and the flag mistakes that exit 1."""

import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

import bronko_tpu.call.engine as je  # noqa: E402
import bronko_tpu.config as jax_config  # noqa: E402
import bronko_tpu.index.build as jax_build  # noqa: E402
import bronko_tpu.index.layout as jax_layout  # noqa: E402
from bronko_tpu_torch import cli  # noqa: E402
from bronko_tpu_torch.io import native  # noqa: E402
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two references and, from the second, four samples with one planted
    major each, the first also as a pair of mates."""
    tmp = tmp_path_factory.mktemp("torch_distributed")
    native.get_lib()  # built once here, before the ranks load it
    rng = np.random.default_rng(61)
    genomes = [make_genome(rng, 1200) for _ in range(2)]
    refs = [str(tmp / f"ref{i}.fasta") for i in range(2)]
    for path, g in zip(refs, genomes):
        write_fasta(path, os.path.basename(path).split(".")[0], g)
    fqs = []
    for i in range(4):
        reads, _ = make_sample(genomes[1], rng, read_len=80, depth=140,
                               major_positions={250 + 90 * i: 0.9}, error_rate=0.003)
        fqs.append(str(tmp / f"cs{i}.fastq.gz"))
        write_fastq(fqs[-1], reads)
        if i == 0:
            pair = [str(tmp / f"cs0_{m}.fastq.gz") for m in (1, 2)]
            write_fastq(pair[0], reads[::2])
            write_fastq(pair[1], reads[1::2])
    return tmp, refs, fqs, pair


def outputs(out) -> dict[str, bytes]:
    return {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}


def ranks(argv: list[str], n: int, torchrun: bool = False) -> list[tuple[int, str]]:
    """`call argv` in n rank processes: the three flags, or torchrun's
    environment. Returns each rank's (exit code, output)."""
    port = free_port()
    env = {**os.environ, "BRONKO_PLATFORM": "cpu", "PYTHONPATH": REPO}
    if torchrun:
        cmds = [[sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
                 "--master-addr", "127.0.0.1", "--master-port", str(port),
                 "-m", "bronko_tpu_torch", "call", *argv]]
    else:
        cmds = [[sys.executable, "-m", "bronko_tpu_torch", "call", *argv,
                 "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
                 "--process-id", str(r)] for r in range(n)]
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    done = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        done.append((p.returncode, out))
    return done


@pytest.fixture(autouse=True)
def keep_caplog(monkeypatch, caplog):
    """cli.main's logging set-up would drop caplog's handler."""
    monkeypatch.setattr(cli, "setup_logging", lambda *args: None)
    caplog.set_level(logging.INFO, logger="bronko")


def one_process(argv: list[str]) -> int:
    try:
        return cli.main(["call", *argv])
    except SystemExit as e:
        return e.code


@pytest.mark.parametrize("launch,mesh", [("flags", "2x1"), ("torchrun", "1x2")])
def test_two_ranks_byte_identical(inputs, monkeypatch, launch, mesh):
    """Two ranks, `--mesh` over a single-end sample and a pair of mates:
    rank 0 writes the files of one process and of bronko_tpu's run_call
    with the same mesh; both ranks exit 0 and log gloo."""
    tmp, refs, fqs, pair = inputs
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    argv = ["-g", *refs, "-r", fqs[0], "-1", pair[0], "-2", pair[1], "--pileup",
            "--batch-size", "4096"]
    out = str(tmp / f"{launch}_{mesh}")
    done = ranks([*argv, "-o", out, "--mesh", mesh], 2, torchrun=launch == "torchrun")
    for code, log in done:
        assert code == 0, log[-4000:]
        assert "backend gloo" in log
    assert one_process([*argv, "-o", str(tmp / f"single_{launch}")]) == 0
    got = outputs(out)
    assert len(got) == 5 and got == outputs(tmp / f"single_{launch}")
    jout = str(tmp / f"jax_{mesh}")
    jindex = jax_build.build_index(21, refs)
    je.run_call(jax_config.CallConfig(genomes=refs, reads=[fqs[0]], first_pairs=[pair[0]],
                                      second_pairs=[pair[1]], output=jout, mesh=mesh,
                                      output_pileup=True, batch_size=4096),
                jindex, jax_layout.build_device_index(jindex))
    assert got == outputs(jout)


def test_mesh_with_a_failing_sample_exits_2_on_every_rank(inputs, monkeypatch):
    """`--mesh 2x1` over a missing file and a good sample: every rank
    counts each sample, so both skip the missing one before any
    collective, map the good one together and exit 2, with the files of
    one process."""
    tmp, refs, fqs, _ = inputs
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    argv = ["-g", *refs, "-r", str(tmp / "missing.fastq.gz"), fqs[2], "--pileup",
            "--batch-size", "4096"]
    done = ranks([*argv, "-o", str(tmp / "mesh_failing"), "--mesh", "2x1"], 2)
    for code, log in done:
        assert code == 2, log[-4000:]
        assert "missing.fastq.gz failed" in log
    assert one_process([*argv, "-o", str(tmp / "single_failing")]) == 2
    got = outputs(tmp / "mesh_failing")
    assert len(got) == 3 and got == outputs(tmp / "single_failing")


def test_shard_samples_byte_identical(inputs, monkeypatch):
    """`--shard-samples` over 4 samples and a missing file on 2 ranks: each
    rank writes its own samples' files, rank 0 the overview; the files
    equal one process's and bronko_tpu's, and both ranks exit 2, as one
    process does."""
    tmp, refs, fqs, _ = inputs
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    reads = [fqs[0], fqs[1], str(tmp / "missing.fastq.gz"), fqs[2], fqs[3]]
    argv = ["-g", *refs, "-r", *reads, "--pileup", "--batch-size", "4096"]
    out = str(tmp / "shard")
    done = ranks([*argv, "-o", out, "--shard-samples"], 2)
    for code, log in done:
        assert code == 2, log[-4000:]
    assert "owns 3 of 5 samples" in done[0][1] and "owns 2 of 5 samples" in done[1][1]
    assert one_process([*argv, "-o", str(tmp / "cohort")]) == 2
    got = outputs(out)
    assert len(got) == 9 and got == outputs(tmp / "cohort")
    jout = str(tmp / "jax_cohort")
    jindex = jax_build.build_index(21, refs)
    summaries = je.run_call(jax_config.CallConfig(genomes=refs, reads=reads, output=jout,
                                                  output_pileup=True, batch_size=4096,
                                                  shard_samples=True),
                            jindex, jax_layout.build_device_index(jindex))
    assert len(summaries) == 4 and got == outputs(jout)


def test_mesh_1x1_in_one_process(inputs, monkeypatch, caplog):
    """`--mesh 1x1` without a launcher: the sharded path on a world of one,
    the files of the one-device run, and no process group left after."""
    tmp, refs, fqs, _ = inputs
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    argv = ["-g", *refs, "-r", fqs[1], "--pileup"]
    assert one_process([*argv, "-o", str(tmp / "m11"), "--mesh", "1x1"]) == 0
    assert "rank 0 of 1" in caplog.text and "mesh layouts used this run: batchwise" in caplog.text
    assert not dist.is_initialized()
    assert one_process([*argv, "-o", str(tmp / "m11_single")]) == 0
    assert outputs(tmp / "m11") == outputs(tmp / "m11_single")


@pytest.mark.parametrize("extra", [
    ["--coordinator", "127.0.0.1:1"],
    ["--num-processes", "2", "--process-id", "0"],
    ["--mesh", "2x2"],
    ["--mesh", "2x2", "--batch-size", "4098"],
    ["--mesh", "2x1", "--device-build", "on"],
    ["--mesh", "1x1", "--shard-samples"],
], ids=["coordinator_only", "no_coordinator", "mesh_2x2_world_of_1", "batch_not_divisible",
        "device_build_on", "mesh_and_shard_samples"])
def test_flag_mistakes_exit_1(inputs, monkeypatch, caplog, extra):
    tmp, refs, fqs, _ = inputs
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    assert one_process(["-g", refs[0], "-r", fqs[0], "-o", str(tmp / "bad"), *extra]) == 1
    assert not dist.is_initialized()
    if extra == ["--mesh", "2x2"]:
        assert "needs 4 ranks, have 1" in caplog.text and "--nproc-per-node 4" in caplog.text


def test_rank_without_a_card_exits_1(inputs, monkeypatch, caplog):
    """BRONKO_PLATFORM=gpu and no CUDA device: a rank exits 1 before it
    meets the others, and never runs on the CPU instead."""
    tmp, refs, fqs, _ = inputs
    monkeypatch.setenv("BRONKO_PLATFORM", "gpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert one_process(["-g", refs[0], "-r", fqs[0], "-o", str(tmp / "nocard"),
                        "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "2",
                        "--process-id", "1"]) == 1
    assert "no CUDA device is available" in caplog.text and not dist.is_initialized()
