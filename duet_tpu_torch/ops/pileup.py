"""Device pileup from packed reads: expand, count, call and compact sites.

The port of ``duet_tpu.ops.pileup``'s ``pileup_call_packed`` /
``packed_window_body`` (``_packed_impl``), ``_hist_counts``,
``pileup_counts`` and ``call_sites``.  Inputs are the
packers' two uploads (``models.snp_caller_host``):

  ops4        (4, K) int32  rows [ref_start, query_start (nibble index),
                            length] of the match-op table; row 3's first 8
                            slots carry [n_real, unused, min_depth, af_num,
                            af_den, hom_num, hom_den, min_alt]
  payload_ref (ns/2 + L,) u8 4-bit codes, one per read base (bits 0-2 the
                            base, bit 3 the host-evaluated qual-pass bit),
                            then L reference codes (4 = never call)

Each lane of the static `total` maps to its op (a binary search of the
ops' cumulative lengths, equal to the JAX kernel's scatter-mark cumsum),
the nibbles decode to (position, base) keys, an int32 scatter-add counts
them into the (L, 4) histogram, and the called sites are compacted
into one flat int32 readback of O(max_sites).  Integer counting has one
answer, so the output is bit-identical to the JAX kernel and the host path.

Two hand kernels on the card (``csrc/pileup.cu``, ``ops.pileup_kernel``):
``pileup_count`` (expand + count) and ``pileup_call`` (call + compact);
their plain versions here, ``count_plain`` and ``call_plain``, run on CPU
tensors and are what the kernels are held against.

JAX drops out-of-bounds scatter updates and clamps gathers; torch raises
on both, so every index here is masked or clamped explicitly.
"""

from __future__ import annotations

import torch

_I32 = torch.int32


def _hist_counts(key: torch.Tensor, length: int,
                 bins: torch.Tensor | None = None) -> torch.Tensor:
    """(length, 4) int32 histogram of `key` = pos*4 + base; keys outside
    [0, 4*length) land in the sentinel bin, which is sliced away.  `bins`,
    the (4*length + 1,) bins of an earlier call, accumulates the keys of
    several calls."""
    sentinel = length * 4
    key = torch.where((key < 0) | (key > sentinel), sentinel, key)
    if bins is None:
        bins = torch.zeros(sentinel + 1, dtype=_I32, device=key.device)
    bins.index_add_(0, key.long(), torch.ones_like(key, dtype=_I32))
    return bins[:sentinel].reshape(length, 4)


def call_sites(counts, ref_codes, min_depth, af_num, af_den, hom_num,
               hom_den, min_alt):
    """Elementwise site calling over the (L, 4) count image; returns
    (is_site, is_het, alt_code, depth, alt_count) with the allele-frequency
    cuts in exact integer form: af >= num/den <=> alt * den >= depth * num."""
    L = counts.shape[0]
    depth = counts.sum(dim=1, dtype=_I32)
    ref_safe = torch.clamp(ref_codes.to(_I32), max=3)
    idx = torch.arange(L, device=counts.device)
    nonref = counts.clone()
    nonref[idx, ref_safe.long()] = -1
    alt_code = torch.argmax(nonref, dim=1).to(_I32)  # first max wins
    alt_count = counts[idx, alt_code.long()]
    is_site = ((depth >= min_depth)
               & (alt_count * af_den >= depth * af_num)
               & (alt_count >= min_alt)
               & (ref_codes < 4)
               & (alt_code != ref_safe))
    is_het = alt_count * hom_den < depth * hom_num
    return is_site, is_het & is_site, alt_code, depth, alt_count


def _compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The first `size` indices where `mask` holds, zero-filled — the
    fixed-shape ``jnp.nonzero(size=..., fill_value=0)``, without a host
    sync: a cumsum gives each hit its slot, extra hits go to a junk slot."""
    slot = torch.cumsum(mask.to(_I32), 0, dtype=_I32) - 1
    keep = mask & (slot < size)
    out = torch.zeros(size + 1, dtype=_I32, device=mask.device)
    out.scatter_(0, torch.where(keep, slot, size).long(),
                 torch.arange(mask.shape[0], dtype=_I32, device=mask.device))
    return out[:size]


def pileup_counts(positions: torch.Tensor, bases: torch.Tensor,
                  quals: torch.Tensor, length: int,
                  min_base_qual) -> torch.Tensor:
    """(L, 4) int32 allele counts from flat observation arrays; the port of
    ``duet_tpu.ops.pileup.pileup_counts``.  base >= 4 (N, and the padding
    convention) never counts; quals below min_base_qual are dropped;
    uint8 bases and quals widen here."""
    keep = (bases < 4) & (quals.to(_I32) >= min_base_qual)
    key = torch.where(keep, positions.to(_I32) * 4 + bases.to(_I32),
                      length * 4)
    return _hist_counts(key, length)


# lanes expanded at once: bounds the per-lane temporaries (int32, 64 MiB
# each) whatever the window's observation count
LANE_CHUNK = 1 << 24


def count_plain(ops4: torch.Tensor, payload_ref: torch.Tensor, *,
                total: int, length: int) -> torch.Tensor:
    """Expand and count: the (4*length + 1,) int32 bins of one window's
    lanes, the last the sentinel of every lane that does not count; the
    plain version of the ``pileup_count`` kernel.

    The lanes go LANE_CHUNK at a time, each counted into the one histogram;
    a lane's op is the number of ops that end at or before it (a binary
    search of the cumulative lengths: zero-length ops end where they start,
    so they are passed over), as the JAX kernel's scatter-mark cumsum
    gives it."""
    op_ref, op_q, op_len = ops4[0], ops4[1], ops4[2]
    n_real = ops4[3, 0]
    nb = payload_ref.shape[0] - length
    payload = payload_ref[:nb]
    dev = ops4.device
    ends = torch.cumsum(op_len, 0, dtype=_I32)
    first_lane = ends - op_len
    last_op = ops4.shape[1] - 1
    sentinel = length * 4
    bins = torch.zeros(sentinel + 1, dtype=_I32, device=dev)
    for l0 in range(0, total, LANE_CHUNK):
        lane = torch.arange(l0, min(l0 + LANE_CHUNK, total), dtype=_I32,
                            device=dev)
        seg = torch.clamp(torch.searchsorted(ends, lane, right=True,
                                             out_int32=True), max=last_op)
        within = lane - first_lane[seg]
        qidx = op_q[seg] + within
        byte = payload[torch.clamp(qidx >> 1, 0, nb - 1)].to(_I32)
        nib = (byte >> ((qidx & 1) << 2)) & 0xF
        base = nib & 7
        keep = (base < 4) & ((nib >> 3) > 0) & (lane < n_real)
        key = torch.where(keep, (op_ref[seg] + within) * 4 + base, sentinel)
        _hist_counts(key, length, bins)
    return bins


def call_plain(bins: torch.Tensor, ref_codes: torch.Tensor,
               params: torch.Tensor, max_sites: int) -> torch.Tensor:
    """Call and compact: the flat int32 [n_sites, site_idx*max_sites,
    alt_code*, is_het*, depth*, alt_count*] of the (4L + 1,) bins against
    the L reference codes, with `params` ops4's row 3; the plain version of
    the ``pileup_call`` kernel.  A slot past the sites holds site_idx 0 and
    position 0's other fields (``jnp.nonzero(fill_value=0)`` gathered)."""
    length = ref_codes.shape[0]
    counts = bins[:length * 4].reshape(length, 4)
    min_depth = params[2]
    af_num, af_den, hom_num, hom_den, min_alt = (
        params[3], params[4], params[5], params[6], params[7])
    is_site, is_het, alt_code, depth, alt_count = call_sites(
        counts, ref_codes, min_depth, af_num, af_den, hom_num, hom_den,
        min_alt)
    n_sites = is_site.sum(dtype=_I32)
    site_idx = _compact(is_site, max_sites)
    at = site_idx.long()
    return torch.cat([n_sites[None], site_idx, alt_code[at],
                      is_het[at].to(_I32), depth[at], alt_count[at]])


def packed_window_body(ops4: torch.Tensor, payload_ref: torch.Tensor, *,
                       total: int, length: int,
                       max_sites: int) -> torch.Tensor:
    """Expand, count, call and compact ONE coordinate window; returns one
    flat int32 tensor [n_sites, site_idx*max_sites, alt_code*, is_het*,
    depth*, alt_count*].  Padding contract (host side): op rows padded so
    the cumulative length covers `total` exactly, pad lanes masked by
    lane < n_real.  The single-device caller (as ``pileup_call_packed``)
    and the mesh's per-shard pileup (``parallel.shard_pileup``) run this
    one function, so the sharded path is the same math by construction.

    The two steps are ``ops.pileup_kernel``'s wrappers: on CUDA tensors
    they launch the hand kernels of ``csrc/pileup.cu`` (a library that
    fails to build or launch raises), on CPU tensors they run the plain
    versions here, ``count_plain`` then ``call_plain``."""
    from duet_tpu_torch.ops.pileup_kernel import pileup_call, pileup_count

    bins = pileup_count(ops4, payload_ref, total=total, length=length)
    nb = payload_ref.shape[0] - length
    return pileup_call(bins, payload_ref[nb:], ops4[3], max_sites)


pileup_call_packed = packed_window_body
