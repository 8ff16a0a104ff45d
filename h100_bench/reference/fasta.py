# A frozen copy of duet_tpu_torch/io/fasta.py for the benchmark's plain
# reference: imports point into h100_bench.reference; the native and
# device routes, and what the reference never calls, are taken out.
"""FASTA + .fai index codec.

The reference requires an indexed FASTA (utils.py:46-50 exits unless
``REFERENCE.fai`` exists) and hands it to external tools. Here the reference
genome is first-class input: contigs are loaded as uint8 base codes ready to
feed device pileup/scoring kernels.
"""

from __future__ import annotations

import numpy as np

# base encoding used across the framework: A=0 C=1 G=2 T=3 N=4
BASE_TO_CODE = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate("ACGT"):
    BASE_TO_CODE[ord(b)] = i
    BASE_TO_CODE[ord(b.lower())] = i
CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def decode_bases(codes: np.ndarray) -> str:
    return CODE_TO_BASE[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


class FastaFile:
    """Random-access FASTA using the .fai index (loads per-contig on demand)."""

    def __init__(self, path: str):
        self.path = path
        self.index: dict[str, tuple[int, int, int, int]] = {}
        self._order: list[str] = []
        with open(path + ".fai") as f:
            for line in f:
                name, length, offset, linebases, linewidth = line.split()[:5]
                self.index[name] = (int(length), int(offset), int(linebases), int(linewidth))
                self._order.append(name)
        self._cache: dict[str, np.ndarray] = {}

    @property
    def contig_names(self) -> list[str]:
        return list(self._order)

    def contig_length(self, name: str) -> int:
        return self.index[name][0]

    def fetch_codes(self, name: str) -> np.ndarray:
        """Whole contig as uint8 base codes (cached).  Native one-pass
        reader when the C++ library is available (the numpy path below
        makes ~4 passes over the raw bytes — seconds per 100 Mb on a
        slow-memory host); bit-identical, pinned by tests."""
        if name not in self._cache:
            length, offset, linebases, linewidth = self.index[name]
            nlines = (length + linebases - 1) // linebases
            nbytes = length + nlines * (linewidth - linebases)
            with open(self.path, "rb") as f:
                f.seek(offset)
                raw = f.read(nbytes)
            arr = np.frombuffer(raw, dtype=np.uint8)
            if linewidth != linebases:
                full = length // linebases
                body = arr[: full * linewidth].reshape(full, linewidth)[:, :linebases].reshape(-1)
                tail = arr[full * linewidth : full * linewidth + (length - full * linebases)]
                arr = np.concatenate([body, tail]) if len(tail) else body
            self._cache[name] = BASE_TO_CODE[arr[:length]]
        return self._cache[name]

    def fetch(self, name: str, start: int = 0, end: int | None = None) -> str:
        codes = self.fetch_codes(name)
        return decode_bases(codes[start:end])

    def drop_cache(self, name: str | None = None) -> None:
        """Release cached contig codes (streaming runs bound memory)."""
        if name is None:
            self._cache.clear()
        else:
            self._cache.pop(name, None)


def write_fasta(path: str, contigs: dict[str, str], line_width: int = 70) -> None:
    with open(path, "w") as f:
        for name, seq in contigs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                f.write(seq[i : i + line_width] + "\n")
    write_fai(path, line_width=line_width)


def write_fai(path: str, line_width: int = 70) -> None:
    """Build the .fai index by scanning the FASTA (samtools faidx equivalent)."""
    entries = []
    with open(path, "rb") as f:
        name = None
        length = 0
        offset = 0
        linebases = linewidth = 0
        pos = 0
        for line in f:
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode()
                length = 0
                offset = pos + len(line)
                linebases = linewidth = 0
            else:
                stripped = line.rstrip(b"\r\n")
                if linebases == 0:
                    linebases = len(stripped)
                    linewidth = len(line)
                length += len(stripped)
            pos += len(line)
        if name is not None:
            entries.append((name, length, offset, linebases, linewidth))
    with open(path + ".fai", "w") as f:
        for name, length, offset, linebases, linewidth in entries:
            f.write(f"{name}\t{length}\t{offset}\t{linebases}\t{linewidth}\n")
