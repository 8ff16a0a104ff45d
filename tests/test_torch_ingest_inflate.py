"""The native reader's inflater hook (``duet_bam_set_inflater``) and the
inflate route rule, on the CPU.

The card's inflater (``ops.bgzf_inflate.CardInflater``) needs a card, so
here a host inflater of the same C signature takes its place: a ctypes
callback that calls zlib per member, set through the same C call, in
batches small enough that a decode takes several.  It must give the same
read store as the zlib pool, in the batch and the stream readers, with the
rolling buffers compacted between batches, and fail with the zlib route's
error text where a member's CRC32, byte count or data is bad.  The route
rule (``PipelineConfig.inflate_device``) keeps every CPU and ``off`` run
on the zlib pool, metrics.json shows the route, and a run whose card
route fails raises, with no fall back to another reader.
"""

import ctypes
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from duet_tpu_torch.io import native_ingest
from duet_tpu_torch.ops import bgzf_inflate
from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline
from duet_tpu_torch.utils import devcost, spans

FIELDS = ("starts", "ends", "strand", "mapq", "supp", "cigar_off",
          "cigar_ops", "cigar_lens", "seq_off", "seq", "qual")
INFLATE_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_void_p,
                              ctypes.c_int64)


class HostInflater:
    """CardInflater's interface over zlib: a batch holds at most two
    members of a simulated BAM (BATCH_IN bytes).  FAIL makes it fail as
    the card can: "open" raises CardInflateError where the card's buffers
    are made, "status" reports a member's bad status (1) for every batch,
    "device" a device error (2)."""

    BATCH_IN, BATCH_OUT, BATCH_MEMBERS = 80_000, 1 << 20, 3
    FAIL = None

    def __init__(self, device, threads):
        if self.FAIL == "open":
            raise bgzf_inflate.CardInflateError("no card buffers")
        self._fn = INFLATE_FN(self._inflate)
        self.batches = self.members = 0
        self._data, self._rows = b"", []

    def _inflate(self, ctx, op, comp, table, n, out, out_bytes):
        if op == 0:
            rows = np.ctypeslib.as_array(
                ctypes.cast(table, ctypes.POINTER(ctypes.c_int64)),
                (n, 4)).copy()
            rows[:, 0] += len(self._data)
            self._data += ctypes.string_at(comp, int(rows[-1, 0] + rows[-1, 1]
                                                     - len(self._data)))
            self._rows += rows.tolist()
            self.members += int(n)
            return 0
        data, rows = self._data, self._rows
        self._data, self._rows = b"", []
        self.batches += 1
        if self.FAIL:
            return {"status": 1, "device": 2}[self.FAIL]
        dst = (ctypes.c_uint8 * out_bytes).from_address(out)
        for a, b, o, m in rows:
            d = zlib.decompressobj(31)
            try:
                got = d.decompress(data[a:a + b])
            except zlib.error:
                return 1
            if not d.eof or len(got) != m:
                return 1
            ctypes.memmove(ctypes.addressof(dst) + o, got, m)
        return 0

    def attach(self, lib, handle):
        lib.duet_bam_set_inflater(
            ctypes.c_void_p(handle), ctypes.cast(self._fn, ctypes.c_void_p),
            None, self.BATCH_IN, self.BATCH_OUT, self.BATCH_MEMBERS)

    def error(self):
        return "device lost" if self.FAIL == "device" else None

    def close(self):
        return {"launches": self.batches, "members": self.members,
                "h2d_bytes": 0, "d2h_bytes": 0, "h2d_s": 0.0,
                "compute_s": 0.0, "d2h_s": 0.0}


@pytest.fixture
def host_inflater(monkeypatch):
    made = []

    def make(device, threads):
        made.append(HostInflater(device, threads))
        return made[-1]

    monkeypatch.setattr(bgzf_inflate, "CardInflater", make)
    return made


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """A three-contig simulated BAM of a few dozen BGZF members."""
    from duet_tpu_torch.sim import SimConfig, simulate_dataset

    out = tmp_path_factory.mktemp("inflate")
    simulate_dataset(str(out), SimConfig(
        contigs={"chrA": 80_000, "chrB": 60_000, "chrC": 50_000}, seed=23,
        coverage=8.0))
    return str(out / "reads.bam")


def _same(a, b):
    assert a.contig == b.contig and a.n == b.n and a.names == b.names
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{a.contig}.{f}")


@pytest.mark.parametrize("reader", ["batch", "stream", "stream_compacted"])
def test_host_inflater_gives_the_zlib_pools_store(bam, host_inflater, reader):
    """Batches through the hook decode to the zlib pool's read store; the
    header's member inflates on the host, every later one in a batch."""
    n_members = len(bgzf_inflate.member_table(open(bam, "rb").read()))
    spans.reset()
    if reader == "batch":
        want = native_ingest.load_read_store_native(bam)
        got = native_ingest.load_read_store_native(bam, inflate_device="x")
        assert list(got.contigs) == list(want.contigs)
        pairs = [(got.contigs[c], want.contigs[c]) for c in want.contigs]
    else:
        compact = 4096 if reader == "stream_compacted" else None
        want = list(native_ingest.stream_read_store_native(
            bam, compact_bytes=compact))
        got = list(native_ingest.stream_read_store_native(
            bam, compact_bytes=compact, inflate_device="x"))
        assert [c.contig for c, _ in got] == [c.contig for c, _ in want]
        pairs = [(g, w) for (g, _), (w, _) in zip(got, want)]
    for g, w in pairs:
        _same(g, w)
    (inflater,) = host_inflater
    assert inflater.members == n_members - 1
    assert inflater.batches >= (n_members - 1) // 2
    counters = spans.snapshot()["counters"]
    assert counters["dispatch.ingest_inflate.card"] == 1
    assert counters["dispatch.ingest_inflate.host"] == 1
    assert counters["ingest.inflate_card_members"] == n_members - 1
    assert counters["ingest.bgzf_members"] == 2 * n_members
    assert devcost.snapshot()["ingest"]["n_dispatch"] == inflater.batches


def _corrupt(bam: str, out: str, fault: str) -> str:
    """`bam` with its fourth BGZF member made bad: a CRC32 bit flipped,
    ISIZE one byte too many, or its DEFLATE data cut short (BSIZE kept
    true to the shorter member, so the member chain stays whole)."""
    data = bytearray(open(bam, "rb").read())
    a, b, _, m = bgzf_inflate.member_table(bytes(data))[3].tolist()
    if fault == "crc32":
        data[a + b - 8] ^= 0x10
    elif fault == "isize":
        data[a + b - 4:a + b] = struct.pack("<I", m + 1)
    else:
        keep = (b - 26) // 2
        member = data[a:a + 18 + keep] + data[a + b - 8:a + b]
        member[16:18] = struct.pack("<H", len(member) - 1)
        data[a:a + b] = member
    with open(out, "wb") as f:
        f.write(bytes(data))
    return out


@pytest.mark.parametrize("fault", ["crc32", "isize", "truncated"])
def test_bad_member_fails_alike_on_both_routes(bam, tmp_path, host_inflater,
                                               fault):
    bad = _corrupt(bam, str(tmp_path / "bad.bam"), fault)
    errors = []
    for device in (None, "x"):
        with pytest.raises(ValueError) as e:
            native_ingest.load_read_store_native(bad, inflate_device=device)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].endswith("BGZF inflate failed")


def test_header_only_open_inflates_the_header_alone(bam):
    """The header parse takes one member at a time: opening for the header
    inflates only the member it spans."""
    lib = native_ingest.get_lib()
    h = lib.duet_bam_open(bam.encode(), 0, 4)
    try:
        assert lib.duet_bam_error(h) is None
        stats = (ctypes.c_double * 9)()
        lib.duet_bam_stats(ctypes.c_void_p(h), stats)
        assert int(stats[7]) == 1
    finally:
        lib.duet_bam_close(ctypes.c_void_p(h))
    assert set(native_ingest.bam_contig_lengths_native(bam)) == \
        {"chrA", "chrB", "chrC"}


@pytest.mark.parametrize("device,stages,card", [
    ("cuda", "auto", True),
    ("cuda", "on", True),
    ("cuda", "off", False),
    ("cpu", "on", False),
    ("cpu", "auto", False),
    ("cpu", "off", False),
])
def test_inflate_route_rule(device, stages, card):
    cfg = PipelineConfig(bam="", reference="", output="", device=device,
                         device_stages=stages)
    want = torch.device(device) if card else None
    assert cfg.inflate_device() == want


def test_host_inflater_with_the_gate_open_in_the_pipeline(
        sim_dataset, tmp_path, host_inflater, monkeypatch):
    """A run the rule sends to the card writes the zlib route's artifacts
    (the host inflater standing in for the card), one card decode and its
    members in metrics.json."""
    data = sim_dataset[0]
    paths = dict(bam=os.path.join(data, "reads.bam"),
                 reference=os.path.join(data, "ref.fa"))
    monkeypatch.setattr(PipelineConfig, "inflate_device",
                        lambda self: torch.device("cpu"))
    run_pipeline(PipelineConfig(output=str(tmp_path / "card"), device="cpu",
                                **paths))
    monkeypatch.undo()
    run_pipeline(PipelineConfig(output=str(tmp_path / "host"), device="cpu",
                                **paths))
    for name in ("snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
                 "phased_sv.vcf"):
        with open(tmp_path / "card" / name, "rb") as f, \
                open(tmp_path / "host" / name, "rb") as g:
            assert f.read() == g.read(), name
    metrics = {}
    for route in ("card", "host"):
        with open(tmp_path / route / "metrics.json") as f:
            metrics[route] = json.load(f)
    assert metrics["card"]["device_dispatch"]["ingest_inflate"] == {"card": 1}
    assert metrics["host"]["device_dispatch"]["ingest_inflate"] == {"host": 1}
    assert metrics["card"]["backends"]["ingest_inflate"] == "card"
    assert metrics["card"]["ingest"]["native"]["inflate_card_members"] == \
        host_inflater[0].members > 0
    assert metrics["host"]["ingest"]["native"]["inflate_card_members"] == 0


@pytest.mark.parametrize("stages", ["auto", "off", "on"])
def test_cpu_runs_take_the_zlib_pool(sim_dataset, tmp_path, stages):
    """On the CPU every mode inflates on the host: one host decode in
    device_dispatch and backends; the card route has no size gate."""
    data = sim_dataset[0]
    out = str(tmp_path / stages)
    run_pipeline(PipelineConfig(bam=os.path.join(data, "reads.bam"),
                                reference=os.path.join(data, "ref.fa"),
                                output=out, device="cpu",
                                device_stages=stages))
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["device_dispatch"]["ingest_inflate"] == {"host": 1}
    assert metrics["backends"]["ingest_inflate"] == "host"
    assert metrics["counters"]["ingest.inflate_card_members"] == 0
    assert "ingest" not in metrics["device_cost"]
    assert "ingest_inflate_min_bytes" not in \
        metrics.get("device_size_gates", {})


@pytest.mark.parametrize("mode", ["batch", "stream"])
@pytest.mark.parametrize("fail", ["open", "status", "device"])
def test_card_route_failure_fails_the_run(sim_dataset, tmp_path,
                                          host_inflater, monkeypatch, mode,
                                          fail):
    """A run the rule sends to the card raises when the card route fails,
    whether the inflater cannot be made, a batch reports a bad member or
    the device fails: no other reader decodes the BAM in its place, and no
    metrics.json is written."""
    from duet_tpu_torch.pipeline import run_pipeline_streaming

    data = sim_dataset[0]
    monkeypatch.setattr(PipelineConfig, "inflate_device",
                        lambda self: torch.device("cpu"))
    monkeypatch.setattr(HostInflater, "FAIL", fail)
    out = tmp_path / "card"
    cfg = PipelineConfig(bam=os.path.join(data, "reads.bam"),
                         reference=os.path.join(data, "ref.fa"),
                         output=str(out), device="cpu")
    run = run_pipeline if mode == "batch" else run_pipeline_streaming
    want = bgzf_inflate.CardInflateError if fail != "status" else ValueError
    with pytest.raises(want) as e:
        run(cfg)
    if fail == "status":
        assert str(e.value).endswith("BGZF inflate failed")
    assert not (out / "metrics.json").exists()
    assert "Python reader" not in (out / "run_duet.log").read_text()


def _members(kind: str) -> list[bytes]:
    data = {"text": b"the quick brown fox jumps over the lazy dog " * 400,
            "runs": b"ab" * 3000 + b"a" * 4000,
            "empty": b""}[kind]
    out = []
    for level in (0, 1, 6, 9):
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        raw = c.compress(data) + c.flush()
        out.append(b"\x1f\x8b\x08\x04\0\0\0\0\0\xff\x06\0BC\x02\0" +
                   struct.pack("<H", 25 + len(raw)) + raw +
                   struct.pack("<II", zlib.crc32(data), len(data)))
    return out


@pytest.mark.parametrize("kind", ["text", "runs", "empty"])
def test_inflate_plain_on_cpu_tensors(kind):
    """The kernel's plain counterpart: zlib per member, each member's
    status and the worst last; a flipped CRC32 bit is status 3, a wrong
    ISIZE status 4."""
    members = _members(kind)
    buf = b"".join(members)
    table = bgzf_inflate.member_table(buf)
    out, status = bgzf_inflate.inflate_members(
        torch.frombuffer(bytearray(buf), dtype=torch.uint8),
        torch.from_numpy(table))
    assert out.numpy().tobytes() == b"".join(
        zlib.decompress(m, 31) for m in members)
    assert status.tolist() == [0] * (len(members) + 1)
    if kind == "empty":
        return
    bad = bytearray(buf)
    a, b, _, _ = table[1].tolist()
    bad[a + b - 8] ^= 1
    c, d, _, _ = table[2].tolist()
    bad[c + d - 4] ^= 1
    _, status = bgzf_inflate.inflate_members(
        torch.frombuffer(bad, dtype=torch.uint8),
        torch.from_numpy(bgzf_inflate.member_table(bytes(bad))))
    assert status.tolist() == [0, 3, 4, 0, 4]
