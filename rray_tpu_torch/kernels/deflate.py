"""The PNG's deflate match search on the card: quantize the image into
the raw PNG stream, link each position to the last one with its hash,
and search every position's longest match under zlib's level-6 limits.
CUDA kernels (kernels/csrc/deflate.cu), their plain PyTorch version, and
the wrapper that picks between them; the chains are linked in torch ops
on every device.

It replaces no TPU kernel: rray_tpu quantizes and deflates on the host
(`native/rray_host.cpp::png_encode`, `compress2(..., 6)`), and so do the
port's host canvases (`render/canvas.py::write_png`). A CLI frame on the
card keeps its image there and hands the host these tables instead; the
host's emitter (`io/csrc/png_deflate.cpp`, bound in `io/deflate.py`)
replays deflate_slow's lazy parse and trees.c's blocks over them and
writes compress2's bytes bit for bit. At config 5's 1920x1080 the raw
stream is 8,295,480 bytes; deflate_slow inserts and searches every one of
them, and that search was ~85% of the host's deflate.

What a position's word holds (int32, `table[p]`), for p < n - 2 (the
positions with three bytes, which zlib hashes; the last two read 0):
  * bits 0-8: the longest match of deflate_slow's longest_match with a
    chain limit of 128 and best_len starting at MIN_MATCH - 1: its length
    (3..258, capped at the bytes left), or 0 where no candidate reaches 3;
  * bits 9-23: its distance, that of the first candidate to reach the
    length;
  * bit 24: the chain's head lies exactly MAX_DIST (32,506) back. A slide
    of zlib's window turns the window base into NIL; near the input's end
    the slide's timing depends on the parse, so the host decides there;
  * bit 25: the result under a chain limit of 32 (prev_length >= 8)
    differs and is longer than 8; a row (p, word) lists it. Each slab of
    1024 positions has its rows together in position order, and the
    `directory` gives each slab's first row and count;
  * bit 26: it differs and is 8 or shorter, so it never beats a
    prev_length of 8 or more.
Where the two limits give the same length they give the same candidate:
the first to reach it lies within the first 32 links.

The candidates of p are zlib's hash chain: the head is the last q < p
with the same hash ((b[q] << 10) ^ (b[q+1] << 5) ^ b[q+2]) & 0x7fff, the
next link the last q' < q with it, and so on. Collisions stay in the
chain and count against its limit. Position 0 is NIL. The head is taken
at a distance of at most MAX_DIST, later links below it. A walk stops
after 128 candidates or at the first length >= nice_match (128, or the
bytes left if fewer). `chain_links` stores each position's link as a
distance, 0 for none or beyond MAX_DIST.
"""
from __future__ import annotations

import torch

MAX_MATCH = 258
MAX_DIST = 32506
NICE_MATCH = 128
MAX_CHAIN = 128
GOOD_CHAIN = MAX_CHAIN >> 2
GOOD_MATCH = 8
HEAD_AT_MAX_DIST = 1 << 24
LISTED = 1 << 25
SHORT32 = 1 << 26

# Match-search launches made by `match_tables` in this process (CPU
# calls, which run the plain version, do not count).
launches = 0
# What the plain version's last search walked, the least work these inputs
# need (chip_smoke.py's bound): the candidates (links followed), those
# compared whole (no match held yet, or the 4 bytes that end at the best
# length agree, as longest_match checks scan_end), and the 4-byte words
# compared: one scan_end word per candidate once a match is held, and the
# words of each whole comparison through its first difference or the cap.
last_work = {"candidates": 0, "compared": 0, "words": 0}


SLAB = 1024


def slabs(n: int) -> int:
    """The directory's length for an n-byte stream."""
    return (n + SLAB - 1) // SLAB


def raw_size(height: int, width: int) -> int:
    """Bytes of the raw PNG stream: a filter byte and width RGBA pixels
    per row."""
    return height * (4 * width + 1)


def quantize_reference(image):
    """[h, w, 3] float image -> the raw PNG stream, uint8 [h * (4w + 1)]:
    each row a filter byte 0 and RGBA8 pixels with alpha 255, the colour
    cast as quantize_rgba casts it: v = float32(x) * 255, NaN and <= 0 to
    0, > 255 to 255, then truncated."""
    h, w = image.shape[:2]
    v = image.to(torch.float32) * 255.0
    v = torch.where(v > 0, v, 0.0)
    v = torch.where(v > 255, 255.0, v)
    rgba = torch.cat([v.to(torch.uint8),
                      torch.full((h, w, 1), 255, dtype=torch.uint8,
                                 device=image.device)], dim=2)
    rows = torch.cat([torch.zeros((h, 1), dtype=torch.uint8,
                                  device=image.device),
                      rgba.reshape(h, 4 * w)], dim=1)
    return rows.reshape(-1)


def hashes(raw):
    """zlib's hash of each position with three bytes, int64 [n - 2]."""
    b = raw.to(torch.int64)
    return ((b[:-2] << 10) ^ (b[1:-1] << 5) ^ b[2:]) & 0x7fff


def chain_links(raw):
    """int16 [n]: p - q for the last q < p of p's hash, where q is not
    NIL (0) and p - q <= MAX_DIST; 0 otherwise. A stable sort of the
    hashes, then each run's predecessor, in torch ops with no wait."""
    n = raw.numel()
    link = torch.zeros(n, dtype=torch.int16, device=raw.device)
    if n < 3:
        return link
    # 16-bit keys: the radix sort takes two passes, not eight.
    sorted_h, order = torch.sort(hashes(raw).to(torch.int16), stable=True)
    prev, cur = order[:-1], order[1:]
    dist = cur - prev
    ok = (sorted_h[1:] == sorted_h[:-1]) & (prev > 0) & (dist <= MAX_DIST)
    link[cur] = torch.where(ok, dist, 0).to(torch.int16)
    return link


def _words(raw):
    """int64 [n + 264]: bytes i..i+7 of the stream, zero past its end,
    little-endian."""
    n = raw.numel()
    b = torch.cat([raw, raw.new_zeros(MAX_MATCH + 14)]).to(torch.int64)
    w = torch.zeros(n + MAX_MATCH + 6, dtype=torch.int64, device=raw.device)
    for k in range(8):
        w |= b[k:k + n + MAX_MATCH + 6] << (8 * k)
    return w


_SHIFTS = torch.arange(0, 64, 8)
_OFFSETS = torch.arange(0, MAX_MATCH, 8)


def _first_diff(x):
    """Index of the first byte where two words differ (x their xor, not
    0)."""
    nonzero = ((x.unsqueeze(-1) >> _SHIFTS.to(x.device)) & 0xff) != 0
    return nonzero.to(torch.int8).argmax(dim=-1)


def _lengths(words, a, b, cap):
    """How many bytes from a and from b agree, capped at cap: the first
    word of every pair, then all 33 words of the pairs whose first word
    agrees."""
    x = words[a] ^ words[b]
    length = torch.where(x == 0, 8, _first_diff(x))
    far = torch.nonzero(x == 0).flatten()
    if far.numel():
        offs = _OFFSETS.to(a.device)
        xs = words[a[far, None] + offs] ^ words[b[far, None] + offs]
        differ = xs != 0
        k = torch.where(differ.any(dim=1), differ.to(torch.int8).argmax(dim=1),
                        len(offs))
        xk = xs.gather(1, k.clamp(max=len(offs) - 1)[:, None]).squeeze(1)
        length[far] = 8 * k + torch.where(k < len(offs), _first_diff(xk), 0)
    return torch.minimum(length, cap)


def directory_of(positions, n: int):
    """int32 [slabs(n), 2]: each slab's first row and count, for rows in
    position order."""
    edges = torch.arange(0, slabs(n) + 1, device=positions.device) * SLAB
    first = torch.searchsorted(positions.contiguous(), edges)
    return torch.stack([first[:-1], first[1:] - first[:-1]],
                       dim=1).to(torch.int32)


def match_tables_reference(raw):
    """Plain PyTorch version of the match search: (table int32 [n], rows
    int32 [m, 2] of (position, word) in position order, directory)."""
    n = raw.numel()
    link = chain_links(raw).to(torch.int64)
    table = torch.zeros(n, dtype=torch.int64, device=raw.device)
    p = torch.nonzero(link > 0).flatten()
    words = _words(raw)
    left = n - p
    cap = left.clamp(max=MAX_MATCH)
    nice = left.clamp(max=NICE_MATCH)
    best = torch.full_like(p, 2)
    best_d = torch.zeros_like(p)
    best32, best_d32 = best, best_d
    cur = p - link[p]
    live = torch.arange(p.numel(), device=raw.device)
    work = {"candidates": 0, "compared": 0, "words": 0}
    for k in range(1, MAX_CHAIN + 1):
        if not live.numel():
            break
        pl, cl, held = p[live], cur[live], best[live]
        got = _lengths(words, pl, cl, cap[live])
        end = (held - 3).clamp(min=0)
        whole = (held < 3) | (((words[pl + end] ^ words[cl + end])
                               & 0xffffffff) == 0)
        work["candidates"] += live.numel()
        work["compared"] += int(whole.sum())
        work["words"] += int((held >= 3).sum()) + int(torch.minimum(
            got // 4 + 1, (cap[live] + 3) // 4)[whole].sum())
        better = got > held
        up = live[better]
        best[up] = got[better]
        best_d[up] = (pl - cl)[better]
        if k == GOOD_CHAIN:
            best32, best_d32 = best.clone(), best_d.clone()
        stop = better & (got >= nice[live])
        step = link[cl]
        nxt = cl - step
        go = ~stop & (step > 0) & (pl - nxt < MAX_DIST) & (k < MAX_CHAIN)
        cur[live] = nxt
        live = live[go]
    found = best >= 3
    word = torch.where(found, best | (best_d << 9), 0)
    word |= (link[p] == MAX_DIST).to(torch.int64) << 24
    differs = best32 != best
    listed = differs & (best32 > GOOD_MATCH)
    word |= listed.to(torch.int64) << 25
    word |= (differs & ~listed).to(torch.int64) << 26
    table[p] = word
    last_work.update(work)
    rows = torch.stack([p[listed], (best32 | (best_d32 << 9))[listed]],
                       dim=1)
    return (table.to(torch.int32), rows.to(torch.int32),
            directory_of(p[listed], n))


def _launch(image):
    from . import build

    device = image.device
    if image.dim() != 3 or image.shape[2] != 3:
        raise ValueError(f"the image has shape {tuple(image.shape)}, "
                         "expected [h, w, 3]")
    image = image.to(torch.float32).contiguous()
    h, w = image.shape[:2]
    n = raw_size(h, w)
    if n >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"a {w}x{h} image's stream is past the kernels' "
                         "int32 positions")
    raw = torch.empty(n, dtype=torch.uint8, device=device)
    table = torch.empty(n, dtype=torch.int32, device=device)
    # Up to n listed rows, their directory, and the count written.
    rows = torch.empty((n, 2), dtype=torch.int32, device=device)
    directory = torch.empty((slabs(n), 2), dtype=torch.int32, device=device)
    count = torch.zeros(1, dtype=torch.int32, device=device)
    ptr, lib = build.ptr, build.load_library()
    with build.device_guard(device):
        stream = build.stream(device)
        rc = lib.png_quantize_launch(ptr(image), ptr(raw), w, h, stream)
        build.check_launch("png_quantize", rc)
        link = chain_links(raw)
        rc = lib.deflate_match_launch(ptr(raw), ptr(link), n, ptr(table),
                                      ptr(rows), ptr(directory), ptr(count),
                                      stream)
    build.check_launch("deflate_match", rc)
    build.count(globals(), "launches")
    return raw, table, rows, directory, count


def match_tables(image):
    """[h, w, 3] float image -> (raw uint8 [n], table int32 [n], rows
    int32 [>= m, 2], directory int32 [slabs(n), 2], count int32 [1]
    holding m): the raw PNG stream and its match tables, left where the
    image lies. CPU tensors run the plain version (exactly m rows, all in
    position order); CUDA tensors launch the kernels, enqueued with no
    wait (each slab's rows in position order, the slabs in no fixed
    order, and only the first `count` rows written)."""
    if image.device.type == "cpu":
        raw = quantize_reference(image)
        table, rows, directory = match_tables_reference(raw)
        count = torch.tensor([rows.shape[0]], dtype=torch.int32)
        return raw, table, rows, directory, count
    return _launch(image)
