"""A streamed lone sample's mates counted on the card (call/device_count.py)
on the CPU, through the text pack's plain version: each mate's k-mers,
counts and CountStats equal the native counter's, case by case of the
FASTQ the native parser accepts, drops or refuses, whole or in parts
(records cut at every offset of a part's end, the floor and the cap
reached only across parts, the parts' merge against its plain version);
the card's count or the host's is decided a part at a time, before its
copy; the gate keeps the host count under --counter host, on a CPU
device, for a mate past the card's budget and for a classic sample, and
the streamed run counted on the card, whole or in parts, writes the host
count's files. Every comparison is exact. The CPU stands in for the card
where a test patches `usable` and `budget`."""

import gzip
import logging
import os
import sys
import threading
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bronko_tpu_torch.call import device_count, engine  # noqa: E402
from bronko_tpu_torch.config import CallConfig  # noqa: E402
from bronko_tpu_torch.consts import KMER_COUNT_CAP  # noqa: E402
from bronko_tpu_torch.index.build import build_index  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.io import native  # noqa: E402
from bronko_tpu_torch.ops.count import (  # noqa: E402
    count_words, fastq_pack, fastq_pack_plain, fastq_records_end, merge_runs, merge_runs_plain,
)
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq  # noqa: E402

CPU = torch.device("cpu")
MIN_KMERS = CallConfig().min_kmers
STREAM_ENV = ("BRONKO_STREAM", "BRONKO_NO_STREAM", "BRONKO_STREAM_FIRST")


def _records(rng, n, alphabet="ACGT", lengths=(30, 80)):
    out = []
    for i in range(n):
        L = int(rng.integers(*lengths))
        seq = "".join(rng.choice(list(alphabet), L))
        out.append(f"@r{i} x\n{seq}\n+\n{'I' * L}\n")
    return out


def _text(case: str) -> bytes:
    """One mate's FASTQ text for each case; reads of one 60-base stretch
    repeat so that k-mers pass the floor."""
    rng = np.random.default_rng(len(case))
    core = "".join(rng.choice(list("ACGT"), 200))
    reads = []
    for i in range(120):
        s = int(rng.integers(0, 140))
        reads.append(core[s:s + int(rng.integers(25, 60))])
    recs = [f"@r{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in enumerate(reads)]
    if case == "n_bases":
        recs = [r.replace("A", "N", 1) if i % 3 == 0 else r for i, r in enumerate(recs)]
    elif case == "lowercase":
        recs = [r.replace("\n" + r.split("\n")[1], "\n" + r.split("\n")[1][:20].lower()
                          + r.split("\n")[1][20:]) for r in recs]
    elif case == "crlf":
        recs = [r.replace("\n", "\r\n") for r in recs]
    elif case == "short_reads":
        recs += [f"@s{i}\n{core[i:i + 10]}\n+\n{'I' * 10}\n" for i in range(30)]
        recs += ["@empty\n\n+\n\n"]
    elif case == "no_final_newline":
        recs[-1] = recs[-1][:-1]
    elif case == "truncated":
        recs += ["@cut\nACGTACGTACGTACGTACGTACGTAC\n+"]
    elif case == "truncated_sequence":
        recs += ["@cut\nACGTACGTACGTACGTACGTACGTAC\n"]
    elif case == "empty":
        recs = []
    elif case == "mixed":
        recs += _records(rng, 40, "ACGTNacgtRY.")
    return "".join(recs).encode()


CASES = ("n_bases", "lowercase", "crlf", "short_reads", "no_final_newline", "truncated",
         "truncated_sequence", "empty", "mixed", "multi_member", "plain")


def _write(path, text: bytes, case: str) -> str:
    if case == "plain":
        with open(path, "wb") as fh:
            fh.write(text)
    elif case == "multi_member":
        cut = len(text) // 3
        cut = text.index(b"\n@", cut) + 1
        with open(path, "wb") as fh:
            fh.write(gzip.compress(text[:cut]) + gzip.compress(text[cut:]))
    else:
        with open(path, "wb") as fh:
            fh.write(gzip.compress(text))
    return str(path)


def _as_card(monkeypatch, room: int = 1 << 40) -> None:
    """The gate takes the CPU as a card under --counter auto, with `room`
    device bytes free."""
    monkeypatch.setattr(device_count, "usable", lambda cfg, device: cfg.counter == "auto")
    monkeypatch.setattr(device_count, "budget", lambda device: room)


@pytest.fixture
def cpu_card(monkeypatch):
    """The CPU taken as a card, with room for any text."""
    _as_card(monkeypatch)


def _staged(path):
    """The whole text of `path` (within one part) staged: its host blocks."""
    blocks, ends, _ = next(device_count.stage_parts(path))
    assert ends
    return blocks


def _in_parts(monkeypatch, part_bytes: int, block_bytes: int | None = None) -> None:
    """Mates counted on the card in parts of `part_bytes` text bytes."""
    monkeypatch.setattr(device_count, "BLOCK_BYTES", block_bytes or part_bytes)
    monkeypatch.setattr(device_count, "PART_BYTES", part_bytes)


def _card_count(path, k=21, count_cap=KMER_COUNT_CAP, counters=None):
    """count_mates of one mate, which the card counts: (k-mers, counts, stats)."""
    counters = {} if counters is None else counters
    (got,) = list(device_count.count_mates([path], k, MIN_KMERS, count_cap, CPU, threads=2,
                                           counters=counters))
    assert counters["device_counted"] == 1
    return got


def _assert_native(got, path, k=21, count_cap=KMER_COUNT_CAP):
    kmers, counts, stats = got
    want_k, want_c, want_st = native.native_count_fastq(path, k, MIN_KMERS, count_cap,
                                                        threads=2)
    np.testing.assert_array_equal(kmers.numpy(), want_k.view(np.int64))
    np.testing.assert_array_equal(counts.numpy(), want_c)
    assert counts.dtype == torch.int32 and stats == want_st


@pytest.mark.parametrize("k", [19, 21])
@pytest.mark.parametrize("case", CASES)
def test_device_count_plain_equals_the_native_count(tmp_path, cpu_card, case, k):
    """stage_text, upload_text, the text pack's plain version and
    count_words: the k-mers, counts and all four CountStats fields of
    native_count_fastq, the whole text staged byte for byte."""
    text = _text("mixed" if case in ("multi_member", "plain") else case)
    path = _write(tmp_path / "m.fastq.gz", text, case)
    got = device_count.upload_text(_staged(path), CPU)
    assert bytes(got.numpy()) == text
    words, reads, malformed = fastq_pack(got, k)
    assert not malformed
    kmers, counts, stats = count_words(words, reads, MIN_KMERS)
    want_k, want_c, want_st = native.native_count_fastq(path, k, MIN_KMERS, KMER_COUNT_CAP,
                                                        threads=2)
    np.testing.assert_array_equal(kmers.numpy(), want_k.view(np.int64))
    np.testing.assert_array_equal(counts.numpy(), want_c)
    assert asdict(stats) == want_st
    assert counts.dtype == torch.int32 and (case == "empty") == (want_st["total_reads"] == 0)


@pytest.mark.parametrize("where", ["first", "later", "truncated_last", "blank_line"])
def test_a_header_without_at_raises_as_the_native_count(tmp_path, cpu_card, where):
    """A record whose header does not start with '@' (the first, a later
    one, a truncated last one, a blank line after the last) is malformed:
    both counts raise ValueError('malformed FASTQ: <path>')."""
    recs = [f"@r{i}\nACGTACGTACGTACGTACGTACGTA\n+\nIIIIIIIIIIIIIIIIIIIIIIIII\n"
            for i in range(4)]
    if where == "first":
        recs[0] = recs[0][1:]
    elif where == "later":
        recs[2] = "r" + recs[2][1:]
    elif where == "truncated_last":
        recs.append("x\nACGT")
    else:
        recs.append("\n")
    path = _write(tmp_path / "bad.fastq.gz", "".join(recs).encode(), "gzip")
    assert fastq_pack_plain(device_count.upload_text(_staged(path), CPU), 21)[2]
    with pytest.raises(ValueError, match="malformed FASTQ: " + str(path)):
        native.native_count_fastq(path, 21, MIN_KMERS, KMER_COUNT_CAP, threads=2)
    with pytest.raises(ValueError, match="malformed FASTQ: " + str(path)):
        list(device_count.count_mates([path], 21, MIN_KMERS, KMER_COUNT_CAP, CPU, threads=2))


@pytest.mark.parametrize("case", ["gzip", "multi_member", "plain"])
def test_staging_spans_many_blocks(tmp_path, monkeypatch, case):
    """A text staged in blocks of 64 bytes (a multi-member gzip's members
    ending inside a block) reaches the device byte for byte, and counts
    as the native counter does."""
    monkeypatch.setattr(device_count, "BLOCK_BYTES", 64)
    text = _text("mixed")
    path = _write(tmp_path / "m.fastq.gz", text, case)
    blocks = _staged(path)
    assert len(blocks) == -(-len(text) // 64) and all(b.numel() == 64 for b in blocks[:-1])
    got = device_count.upload_text(blocks, CPU)
    assert bytes(got.numpy()) == text
    words, reads, malformed = fastq_pack(got, 21)
    kmers, counts, stats = count_words(words, reads, MIN_KMERS)
    want_k, want_c, want_st = native.native_count_fastq(path, 21, MIN_KMERS, KMER_COUNT_CAP,
                                                        threads=2)
    np.testing.assert_array_equal(kmers.numpy(), want_k.view(np.int64))
    np.testing.assert_array_equal(counts.numpy(), want_c)
    assert not malformed and asdict(stats) == want_st


@pytest.mark.parametrize("why", ["later_part_past_budget", "past_budget", "missing",
                                 "corrupt"])
def test_a_mate_the_card_does_not_take_is_counted_by_the_host(tmp_path, cpu_card, monkeypatch,
                                                              caplog, why):
    """A mate whose text, or a later part of it after the card counted the
    first, is past the card's budget is counted by the host, as
    native_count_fastq_stream counts it, with a warning; a missing file
    and a gzip cut short raise the host count's own errors."""
    text = _text("mixed")
    path = _write(tmp_path / "m.fastq.gz", text, "gzip")
    if why == "later_part_past_budget":
        _in_parts(monkeypatch, len(text) // 4)
        asked = []
        monkeypatch.setattr(device_count, "budget",
                            lambda device: 0 if asked.append(device) or len(asked) > 1
                            else 1 << 40)
    elif why == "past_budget":
        monkeypatch.setattr(device_count, "budget",
                            lambda device: device_count.BYTES_PER_TEXT_BYTE * len(text) - 1)
    elif why == "missing":
        path = str(tmp_path / "none.fastq.gz")
    else:
        with open(path, "rb") as fh:
            data = fh.read()
        with open(path, "wb") as fh:
            fh.write(data[:len(data) // 2])
    caplog.set_level(logging.WARNING, logger="bronko")
    counters = {"piped": 0, "device_counted": 0}
    run = lambda: list(device_count.count_mates([path], 21, MIN_KMERS,  # noqa: E731
                                                KMER_COUNT_CAP, CPU, threads=2,
                                                counters=counters))
    if why == "missing":
        with pytest.raises(OSError, match="cannot open"):
            run()
        return
    if why == "corrupt":
        with pytest.raises(ValueError, match="malformed FASTQ"):
            run()
        return
    got = run()
    want = list(native.native_count_fastq_stream([path], 21, MIN_KMERS, KMER_COUNT_CAP,
                                                 threads=2))
    assert len(got) == len(want) == native.NATIVE_COUNT_PARTS
    for (gk, gc, gs), (wk, wc, ws) in zip(got, want):
        assert gk.dtype == torch.int64 and gc.dtype == torch.int32
        np.testing.assert_array_equal(gk.numpy(), wk.view(np.int64))
        np.testing.assert_array_equal(gc.numpy(), wc)
        assert gs == ws
    assert counters == {"piped": 1, "device_counted": 0}
    assert f"{path} is counted on the host, not on the card" in caplog.text
    if why == "later_part_past_budget":
        assert len(asked) == 2


def test_the_card_or_the_host_is_decided_once_a_mate_before_the_copy(tmp_path, monkeypatch,
                                                                     caplog):
    """The budget is read once a mate, after its staging and before any of
    it goes to the card: a pair whose mate 2 is past the budget counts
    mate 1 on the card and mate 2 on the host, which never packs it."""
    caplog.set_level(logging.WARNING, logger="bronko")
    t1, t2 = _text("mixed"), _text("n_bases") * 3
    p1 = _write(tmp_path / "m_1.fastq.gz", t1, "gzip")
    p2 = _write(tmp_path / "m_2.fastq.gz", t2, "gzip")
    asked, packed = [], []
    room = device_count.BYTES_PER_TEXT_BYTE * len(t1)

    def budget(device):
        asked.append(device)
        return room

    def pack(text, k):
        packed.append(text.numel())
        return fastq_pack(text, k)

    monkeypatch.setattr(device_count, "budget", budget)
    monkeypatch.setattr(device_count, "fastq_pack", pack)
    counters = {"piped": 0, "device_counted": 0}
    got = list(device_count.count_mates([p1, p2], 21, MIN_KMERS, KMER_COUNT_CAP, CPU,
                                        threads=2, counters=counters))
    assert len(asked) == 2 and packed == [len(t1)]
    assert counters == {"piped": 1, "device_counted": 1, "count_parts": 1}
    assert len(got) == 1 + native.NATIVE_COUNT_PARTS
    assert caplog.text.count("is counted on the host") == 1 and p2 in caplog.text
    kmers, counts, stats = got[0]
    want_k, want_c, want_st = native.native_count_fastq(p1, 21, MIN_KMERS, KMER_COUNT_CAP,
                                                        threads=2)
    np.testing.assert_array_equal(kmers.numpy(), want_k.view(np.int64))
    np.testing.assert_array_equal(counts.numpy(), want_c)
    assert stats == want_st


def _fixed_records(n: int, seed: int = 7, read_len: int = 40) -> tuple[bytes, int]:
    """n records of one length each (reads from one 120-base stretch, so
    that k-mers pass the floor): the text and a record's bytes."""
    rng = np.random.default_rng(seed)
    core = "".join(rng.choice(list("ACGT"), 120))
    recs = []
    for i in range(n):
        s = int(rng.integers(0, 120 - read_len))
        recs.append(f"@r{i:04d}\n{core[s:s + read_len]}\n+\n{'I' * read_len}\n")
    return "".join(recs).encode(), len(recs[0])


@pytest.mark.parametrize("k", [19, 21])
def test_parts_cut_at_every_offset_of_a_record_equal_the_native_count(tmp_path, cpu_card,
                                                                      monkeypatch, k):
    """A mate of records of one length, counted in parts whose ends fall at
    every offset of a record (header, sequence, '+' and quality lines,
    each newline): the k-mers, counts and all four stats of
    native_count_fastq, in as many parts as the text takes."""
    text, rec = _fixed_records(40)
    path = _write(tmp_path / "m.fastq.gz", text, "gzip")
    for part in range(2 * rec, 3 * rec):
        _in_parts(monkeypatch, part)
        counters = {}
        _assert_native(_card_count(path, k, counters=counters), path, k)
        assert counters["count_parts"] > 1


PART_CASES = ("n_bases", "crlf", "short_reads", "no_final_newline", "truncated",
              "truncated_sequence", "mixed", "multi_member", "plain")


@pytest.mark.parametrize("part", [97, 256, 1000])
@pytest.mark.parametrize("case", PART_CASES)
def test_a_mate_counted_in_parts_equals_the_native_count(tmp_path, cpu_card, monkeypatch,
                                                         case, part):
    """Each case of FASTQ (CRLF, N bases, short and empty reads, a last
    record cut short or without its final newline, multi-member gzip,
    plain text) counted in parts of `part` text bytes: the k-mers, counts
    and all four stats of native_count_fastq; a part shorter than a record
    carries the whole part into the next."""
    text = _text("mixed" if case in ("multi_member", "plain") else case)
    path = _write(tmp_path / "m.fastq.gz", text, case)
    _in_parts(monkeypatch, part)
    counters = {}
    _assert_native(_card_count(path, counters=counters), path)
    assert counters["count_parts"] == len(text) // part + 1


@pytest.mark.parametrize("across", ["floor", "cap"])
def test_the_floor_and_the_cap_apply_to_the_sum_over_parts(tmp_path, cpu_card, monkeypatch,
                                                           across):
    """A k-mer counted 2 times in each of two parts passes the floor of 3
    only in the merge; one counted 3 times in each reaches a cap of 5 only
    there: both as native_count_fastq counts the whole text."""
    seen = 2 if across == "floor" else 3
    cap = KMER_COUNT_CAP if across == "floor" else 5
    marker = "GATTACAGATTACAGATTACAG"  # one 21-mer and the 22-mer around it
    text, rec = _fixed_records(8, read_len=22)
    lone = "".join(f"@m{i:03d}\n{marker}\n+\n{'I' * 22}\n" for i in range(seen))
    text = (lone + text.decode() + lone).encode()
    path = _write(tmp_path / "m.fastq.gz", text, "gzip")
    _in_parts(monkeypatch, len(text) // 2 + 1)
    counters = {}
    kmers, counts, stats = _card_count(path, count_cap=cap, counters=counters)
    _assert_native((kmers, counts, stats), path, count_cap=cap)
    assert counters["count_parts"] == 2
    word = 0
    for b in marker[:21]:
        word = word << 2 | "ACGT".index(b)
    at = int(torch.searchsorted(kmers, word))
    assert int(kmers[at]) == word and int(counts[at]) == min(2 * seen, cap)
    whole = {}
    _in_parts(monkeypatch, 1 << 20)
    wk, wc, _ = _card_count(path, count_cap=cap, counters=whole)
    assert whole["count_parts"] == 1
    assert torch.equal(wk, kmers) and torch.equal(wc, counts)


@pytest.mark.parametrize("seed", range(6))
def test_the_merge_of_parts_equals_its_plain_version(seed):
    """merge_runs against merge_runs_plain (and both against one count of
    all the windows) on random runs of 1-5 parts, k-mers shared across
    parts and counts near the floor and the cap."""
    rng = np.random.default_rng(seed)
    words = torch.from_numpy(rng.integers(0, 60, int(rng.integers(1, 400))).astype(np.int64))
    cut = sorted(rng.integers(0, words.numel() + 1, int(rng.integers(0, 5))).tolist())
    runs = [torch.unique(p, sorted=True, return_counts=True)
            for p in torch.tensor_split(words, cut)]
    for min_count, cap in ((3, KMER_COUNT_CAP), (2, 6), (1, 1)):
        got = merge_runs(runs, min_count, cap)
        want = merge_runs_plain(runs, min_count, cap)
        whole = count_words(words, 0, min_count, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2] == want[2] == whole[2].unique_kmers
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1].to(torch.int32), whole[1])


@pytest.mark.parametrize("tail", ["", "@r", "@r\nAC", "@r\nACGT\n+\n", "@r\nACGT\n+\nII"])
def test_records_end_after_the_last_whole_record(tail):
    """fastq_records_end: the bytes up to the newline ending the last
    record's quality line; 0 when no record is whole."""
    whole = "@a\nACGT\n+\nIIII\n@b\nAC\n+\nII\n"
    for head in ("", whole):
        text = torch.tensor(list((head + tail).encode()), dtype=torch.uint8)
        assert fastq_records_end(text) == len(head)


def test_parts_of_many_mates_stay_within_the_parts_in_flight(tmp_path, cpu_card, monkeypatch):
    """Six mates staged on helper threads at once, in parts of 256 bytes,
    with the interpreter switching threads every microsecond: each mate's
    count equals native_count_fastq, no mate ever has more than
    PARTS_IN_FLIGHT parts staged and not yet counted, and a consumer that
    stops after the first mate leaves no helper running."""
    paths = [_write(tmp_path / f"m{i}.fastq.gz", _text("mixed" if i % 2 else "n_bases"),
                    "gzip") for i in range(6)]
    _in_parts(monkeypatch, 256)
    lock, staged, worst = threading.Lock(), {}, [0]
    stage, count = device_count.stage_parts, device_count._count_part

    def staging(path):
        for part in stage(path):
            with lock:
                staged[path] = staged.get(path, 0) + 1
                worst[0] = max(worst[0], staged[path])
            yield part

    def counting(mate, *args):
        with lock:
            staged[mate.path] -= 1
        return count(mate, *args)

    monkeypatch.setattr(device_count, "stage_parts", staging)
    monkeypatch.setattr(device_count, "_count_part", counting)
    before = threading.active_count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        counters = {}
        got = list(device_count.count_mates(paths, 21, MIN_KMERS, KMER_COUNT_CAP, CPU,
                                            threads=2, counters=counters))
        gen = device_count.count_mates(paths, 21, MIN_KMERS, KMER_COUNT_CAP, CPU, threads=2)
        next(gen)
        gen.close()
    finally:
        sys.setswitchinterval(interval)
    assert counters["device_counted"] == 6 and counters["count_parts"] > 6 * 20
    for g, path in zip(got, paths):
        _assert_native(g, path)
    assert 1 <= worst[0] <= device_count.PARTS_IN_FLIGHT
    assert threading.active_count() == before


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A 3 kb genome in 3 strains and a pair of mates of its first."""
    tmp = tmp_path_factory.mktemp("device_count")
    rng = np.random.default_rng(53)
    base = make_genome(rng, 3000)
    genomes = []
    for i in range(3):
        g = bytearray(base)
        for p in rng.integers(0, len(g), 8):
            g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1 + i) % 4]
        genomes.append(str(tmp / f"g{i}.fasta"))
        write_fasta(genomes[-1], f"g{i}", bytes(g))
    reads, _ = make_sample(base, rng, read_len=90, depth=200,
                           major_positions={900: 0.9}, error_rate=0.004)
    r1, r2 = str(tmp / "s_1.fastq.gz"), str(tmp / "s_2.fastq.gz")
    write_fastq(r1, reads[::2])
    write_fastq(r2, reads[1::2])
    index = build_index(21, genomes)
    return genomes, r1, r2, index, build_device_index(index, CPU)


def _run(pair, out, monkeypatch, env, counter="auto"):
    genomes, r1, r2, index, dev = pair
    for var in STREAM_ENV:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = CallConfig(genomes=genomes, first_pairs=[r1], second_pairs=[r2], output=str(out),
                     output_pileup=True, batch_size=1024, counter=counter)
    (res,) = engine.run_call(cfg, index, dev)
    return res, {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}


GATE_CASES = {  # id: (the CPU taken as a card, budget, env, counter, mates counted on the card)
    "device": (True, 1 << 40, {}, "auto", 2),
    "counter_host": (True, 1 << 40, {}, "host", 0),
    "cpu_device": (False, 1 << 40, {}, "auto", 0),
    "past_budget": (True, 1, {}, "auto", 0),
    "stream_0": (True, 1 << 40, {"BRONKO_STREAM": "0"}, "auto", 0),
    "parts": (True, 1 << 40, {}, "auto", 2),  # each mate in parts of 64 KiB
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_the_gate_picks_the_count_and_the_files_stay_the_hosts(pair, tmp_path, monkeypatch,
                                                              caplog, case):
    """The streamed pair counted on the card (here the CPU, through the
    plain pack), whole or in parts, writes the host count's VCF, pileup
    and overview, with its tallies, genome and pileup; --counter host, a
    CPU device, a budget no mate fits and BRONKO_STREAM=0 (a classic
    sample) count on the host, device_counted 0."""
    card, room, env, counter, on_card = GATE_CASES[case]
    caplog.set_level(logging.INFO, logger="bronko")
    if card:
        _as_card(monkeypatch, room)
    if case == "parts":
        _in_parts(monkeypatch, 64 << 10, 16 << 10)
    res, got = _run(pair, tmp_path / "got", monkeypatch, env, counter)
    monkeypatch.undo()
    want_res, want = _run(pair, tmp_path / "want", monkeypatch, {}, "host")
    assert res.counts["device_counted"] == on_card
    assert res.path == ("hist", "saved" if case == "stream_0" else "streamed")
    assert f"{on_card} on the card" in caplog.text or case == "stream_0"
    assert len(got) == 3 and got == want
    assert res.best == want_res.best
    np.testing.assert_array_equal(res.tallies, want_res.tallies)
    np.testing.assert_array_equal(res.pileup, want_res.pileup)
    if on_card:
        s = res.seconds
        # mate 2 uploads on the helper; no mate is piped
        assert res.counts["piped"] == 0 and 0 < s["inflate_ahead"] < s["inflate"]
        assert s["parse"] > 0 and s["finalize"] > 0 and s["dispatch"] > 0
        parts = res.counts["count_parts"]
        # a mate in one part has its cap and floor in finalize, as a whole text
        assert (s["merge"] > 0) == (parts > 2) == (case == "parts")
        assert parts == 2 or case == "parts"
        assert f"{on_card} on the card in {parts} part(s)" in caplog.text
