"""The comparison that decides ``correct``: a sample's artifacts against
the plain reference's, layer by layer.

Each layer's number is the count of artifact lines that differ (a multiset
difference, header lines included); its limit is 0.  Under the neural
caller the SNP-calling layer counts apart the calls whose class differs
from the reference's argmax with every other field as the reference writes
it for that class: those are read as the gap by which the reference's
logit of the served class lies below its best (``snp_nn_gap``), and the
later layers take the program's calls (``reference.pipeline``'s
``follow``).

The reference runs with the traffic's flags: its ``RunFlags`` takes every
key of the traffic's ``pipeline`` that is one of its fields
(``reference_flags``).  The keys of ``ROUTE_ONLY`` choose where the
program computes, not what, and stay with the program; a traffic that sets
any other key is one the reference cannot honour, and ``harness.load_cell``
refuses its cell (``unhonoured``).

A cell whose traffic runs the pipeline contig by contig (``"entry":
"stream"``, ``pipeline.run_pipeline_streaming``) is judged against the
same reference, with the same ``follow``: the streaming run writes the
batch run's artifacts under the same paths (``run_pipeline_streaming``'s
docstring; ``tests/test_torch_modes.py``), so what holds the batch run to
the host route holds it too.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
from collections import Counter

from h100_bench.reference.pipeline import RunFlags, run_reference
from h100_bench.reference.stages import FLOAT32, Precision

BASES = "ACGT"
LAYERS = ("snp_calling", "sv_calling", "snp_phasing", "sv_phasing")
# the program's outputs do not depend on these (ROADMAP "Reference
# semantics"; tests/test_torch_flags.py): they pick routes, not results
ROUTE_ONLY = ("device_stages", "threads", "use_device_kernel")
FLAGS = tuple(f.name for f in dataclasses.fields(RunFlags))


def reference_flags(pipeline: dict) -> RunFlags:
    """The reference's flags for a traffic's ``pipeline`` dict: every key
    that is a field of ``RunFlags``, the rest at their defaults."""
    return RunFlags(**{k: v for k, v in pipeline.items() if k in FLAGS})


def unhonoured(pipeline: dict) -> list[str]:
    """The keys of a traffic's ``pipeline`` dict that the reference cannot
    honour: neither one of its flags nor a route."""
    return sorted(set(pipeline) - set(FLAGS) - set(ROUTE_ONLY))


def _layer(rel: str) -> str:
    return rel.split("/")[0] if "/" in rel else "sv_phasing"


def _is_artifact(rel: str) -> bool:
    if rel in ("snp_calling/pileup.vcf", "sv_calling/variants.vcf",
               "phased_sv.vcf"):
        return True
    return rel.startswith("snp_phasing/") and (
        rel.endswith(".vcf") or rel.endswith(".haplotags.tsv"))


def port_artifacts(out: str) -> list[tuple[str, list[str]]]:
    """(relative path without .gz, lines) of every artifact under `out`,
    sorted by path; .gz files are read through gzip (BGZF is gzip)."""
    found = []
    for dirpath, _, files in os.walk(out):
        for name in files:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, out).replace(os.sep, "/")
            plain = rel[:-3] if rel.endswith(".gz") else rel
            if not _is_artifact(plain):
                continue
            opener = gzip.open if rel.endswith(".gz") else open
            with opener(full, "rt") as f:
                found.append((plain, f.read().splitlines()))
    return sorted(found)


def _gt_class(line: str) -> int:
    return {"0/1": 1, "1/1": 2}.get(line.split("\t")[9].split(":")[0], -1)


def _nn_lines(nn: dict) -> dict:
    """(contig, 1-based pos) -> (logits, {class: the reference's line for
    that class}) over every neural candidate, in write_pileup_vcf's
    format."""
    out = {}
    for contig, c in nn.items():
        for k in range(len(c.pos)):
            p, dp, ac = int(c.pos[k]) + 1, int(c.depth[k]), int(c.alt_count[k])
            head = (f"{contig}\t{p}\t.\t{BASES[c.ref_code[k]]}\t"
                    f"{BASES[c.alt_code[k]]}\t{ac}\tPASS\t.\tGT:DP:AD\t")
            tail = f":{dp}:{dp - ac},{ac}"
            out[(contig, p)] = (c.logits[k], {1: head + "0/1" + tail,
                                              2: head + "1/1" + tail})
    return out


def snp_diff(port: list[str], ref: list[str], nn: dict):
    """(lines that differ, the widest logit gap of a served class or None
    under the counting rule)."""
    extra = Counter(port) - Counter(ref)
    missing = Counter(ref) - Counter(port)
    if not nn:
        return sum(extra.values()) + sum(missing.values()), None
    cands = _nn_lines(nn)

    def key(line):
        cols = line.split("\t")
        return (cols[0], int(cols[1])) if len(cols) > 9 and \
            not line.startswith("#") else None

    port_sites = {key(line) for line in port}
    served = {}
    for line in list(extra.elements()):
        k = key(line)
        if k in cands and cands[k][1].get(_gt_class(line)) == line \
                and k not in served:
            served[k] = _gt_class(line)
            extra[line] -= 1
    for line in list(missing.elements()):
        k = key(line)
        if k in cands and k not in served and k not in port_sites:
            served[k] = 0   # the reference calls a site the program does not
            missing[line] -= 1
        elif k in served:
            missing[line] -= 1
    gap = 0.0
    for k, cls in served.items():
        logits = cands[k][0]
        gap = max(gap, float(logits.max() - logits[cls]))
    n = sum(v for v in extra.values() if v > 0) + \
        sum(v for v in missing.values() if v > 0)
    return n, gap


def judge(out: str, ref_dir: str, nn: dict, limits: dict) -> dict:
    """{number: {"value", "limit"}} for the artifacts under `out` against
    the reference's under `ref_dir`."""
    port = dict(port_artifacts(out))
    ref = dict(port_artifacts(ref_dir))
    diff = dict.fromkeys(LAYERS, 0)
    gap = None
    for rel in sorted(set(port) | set(ref)):
        a, b = port.get(rel, []), ref.get(rel, [])
        if rel == "snp_calling/pileup.vcf":
            n, gap = snp_diff(a, b, nn)
        else:
            n = sum(((Counter(a) - Counter(b)) +
                     (Counter(b) - Counter(a))).values())
        diff[_layer(rel)] += n + (rel not in port) + (rel not in ref)
    checks = {f"{layer}_lines": {"value": n, "limit": limits[f"{layer}_lines"]}
              for layer, n in diff.items()}
    if gap is not None:
        checks["snp_nn_gap"] = {"value": gap, "limit": limits["snp_nn_gap"]}
    return checks


def check_sample(out: str, data: str, ref_dir: str, flags: RunFlags,
                 limits: dict) -> dict:
    """Run the reference on the input under `data` with `flags` (the
    traffic's, ``reference_flags``), and judge the sample under `out`
    against it."""
    ref = run_reference(os.path.join(data, "reads.bam"),
                        os.path.join(data, "ref.fa"), ref_dir, flags, FLOAT32,
                        follow=os.path.join(out, "snp_calling",
                                            "pileup.vcf.gz"))
    return judge(out, ref.out_dir, ref.nn, limits)


def control_checks(data: str, work: str, pipeline: dict, limits: dict,
                   prec: Precision) -> dict:
    """The control: the reference computed in `prec` put in the program's
    place, judged as a sample is, both with the flags of the traffic's
    `pipeline` dict."""
    bam, fa = os.path.join(data, "reads.bam"), os.path.join(data, "ref.fa")
    flags = reference_flags(pipeline)
    ctrl = os.path.join(work, "control")
    run_reference(bam, fa, ctrl, flags, prec)
    ref = run_reference(bam, fa, os.path.join(work, "ref"), flags, FLOAT32,
                        follow=os.path.join(ctrl, "snp_calling",
                                            "pileup.vcf"))
    return judge(ctrl, ref.out_dir, ref.nn, limits)
