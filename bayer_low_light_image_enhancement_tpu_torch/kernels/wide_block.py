"""K2 and K3 at the wide widths, C = 384 and 512 (RawFormer-B's and -L's
bottleneck), as a chain of kernels over the whole call.

At these widths each of the block's 1x1 convs is a dense GEMM (K and N of
384 to 1024), so the passes run as whole-call kernels
(``csrc/wide_block.cu``) with their intermediates in device memory:

* K2 (``gram_pass_wide``): ``layernorm_rows`` (LN1 of the rows the 1x1
  needs) -> ``gemm`` (z = x-hat @ wqk + bqk, fp32, zero outside the frame)
  -> ``dw3x3`` (q, k in bf16, zero outside the counted rows, with per-CTA
  partial sums of q^2 and k^2) -> the gram q^T k per image through the
  weight-grad pass (``kernels/weight_grad.weight_grad``, TMA-fed wgmma) ->
  ``gram_finish`` (the operator's [B, C*C + 2C] row: the gram, then the
  partial sums summed in order);
* K3 (``apply_pass_wide``): ``layernorm_rows`` -> ``gemm`` (the v 1x1) ->
  ``dw3x3`` (v) -> ``gemm`` per image (y = x + v @ apply[b] + b_proj, bf16)
  -> ``layernorm_rows`` (LN2 of y) -> ``gemm`` (the FFN expand) -> ``dw3x3``
  (GELU, bf16) -> ``gemm`` (out = y + f @ wp2 + bp2).

``wide_plan`` lays a call out on the host: the rows each pass reads and
writes (band mode: the band's rows and their halos), the frame masks, each
product's shape and tiles, the dw passes' grids and the shapes handed to the
weight-grad pass; the CPU tests check it. Each kernel's wrapper runs its
plain twin (``*_plain``, the same rounding points) on CPU tensors and the
kernel on CUDA tensors, or raises; ``<wrapper>.launches`` counts the
launches. ``gram_pass_wide`` / ``apply_pass_wide`` therefore run on either
device: on the CPU through the twins, each step's result rounded where the
kernel's is.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.kernels import _build
from bayer_low_light_image_enhancement_tpu_torch.kernels import weight_grad as wgk

WIDE_WIDTHS = (384, 512)
GEMM_TILE_M = 128  # rows of a GEMM tile (kGm)
GEMM_K_STEP = 64  # K rows a ring stage (kGk)
GEMM_STAGES = 4  # ring slots (kGStages)
GEMM_THREADS = 288  # two consumer warpgroups and the producer warp (kGThreads)
GEMM_TILE_NS = (256, 192)  # output columns of a tile, widest first
DW_ROWS, DW_COLS, DW_CHANNELS = 8, 8, 128  # a dw CTA: 8 columns x 8 rows x 128 channels
DW_EPIS = ("qk", "v", "gelu")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_smem(tn: int) -> int:
    """The GEMM's dynamic shared memory at tile width tn (``gemm_smem`` of
    wide_block.cu): 1024 bytes of alignment slack, the ring (a 128 x 64 A box
    and tn / 64 B boxes of 64 x 64 a stage, bf16), the full and empty
    barriers."""
    stage = GEMM_TILE_M * GEMM_K_STEP * 2 + tn // 64 * 64 * GEMM_K_STEP * 2
    return 1024 + GEMM_STAGES * stage + 2 * GEMM_STAGES * 8


# ----------------------------------------------------------------------------
# The plan
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Frame:
    """Which rows of a [B, rows, W, ch] buffer are real: row r of image b is
    frame row ``(b % bands) * hb + first + r``, real where that lies in
    [0, frame_h). A whole image is ``Frame(1, 0, 0, rows)``."""

    bands: int
    hb: int
    first: int
    frame_h: int

    def rows_of(self, b: int, rows: int, device=None) -> torch.Tensor:
        """[b, rows]: the frame row of each row."""
        band = torch.arange(b, device=device) % self.bands
        return band[:, None] * self.hb + self.first + torch.arange(rows, device=device)[None, :]

    def mask(self, b: int, rows: int, device=None) -> torch.Tensor:
        """[b, rows, 1, 1] fp32: 1 on real rows."""
        fr = self.rows_of(b, rows, device)
        return ((fr >= 0) & (fr < self.frame_h)).float()[:, :, None, None]


def tile_n(n: int) -> int:
    """A GEMM's tile width: the widest of GEMM_TILE_NS that divides N."""
    for t in GEMM_TILE_NS:
        if n % t == 0:
            return t
    raise ValueError(f"no GEMM tile width divides N = {n}")


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One product: A [g, m, k] @ B ([k, n], or [g, k, n] if ``batched``)
    on 128 x ``tn`` tiles. Output row p (of g m) is pixel (p // (rows w),
    p // w % rows, p % w) of a [*, rows, w, n] tensor: fp32 z (bias, then
    zero outside ``frame``), or with ``res_rows`` bf16 (bias plus the
    residual's row r + ``res_dr`` of a [*, res_rows, w, n] tensor)."""

    g: int
    m: int
    k: int
    n: int
    batched: bool
    rows: int
    w: int
    frame: Optional[Frame] = None
    res_rows: int = 0
    res_dr: int = 0

    @property
    def tn(self) -> int:
        return tile_n(self.n)

    @property
    def tiles(self) -> int:
        return self.g * _cdiv(self.m, GEMM_TILE_M) * (self.n // self.tn)

    @property
    def flops(self) -> int:
        return 2 * self.g * self.m * self.k * self.n


@dataclasses.dataclass(frozen=True)
class Dw:
    """One depthwise pass: output row r < ``ro`` of each of ``b`` images is
    the 3x3 centred on row r + ``dz`` of z [b, rz, w, f] (zero outside its
    rows and columns); ``epi`` "qk" (q and k, zero outside ``frame``, with
    the CTAs' sums of squares), "v" or "gelu". ``nx`` CTAs an image and
    channel group: the rows of the partial sums."""

    b: int
    rz: int
    ro: int
    dz: int
    w: int
    f: int
    epi: str
    frame: Optional[Frame] = None

    @property
    def nx(self) -> int:
        return _cdiv(self.w, DW_COLS) * _cdiv(self.ro, DW_ROWS)


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """A wide K2 ("gram") or K3 ("apply") call on x [b, hin, w, c] (hin = h,
    or h + 4 in band mode) giving h rows an image: the LayerNorm passes'
    (first row, rows) (K3: of x, then of y), the products and the dw passes
    in the order they run, the weight-grad pass's (G, K, M, N) (K2), and the
    scratch buffers the wrapper allocates (name, shape, dtype)."""

    kind: str
    b: int
    hin: int
    h: int
    w: int
    c: int
    ln: Tuple[Tuple[int, int], ...]
    gemms: Tuple[Gemm, ...]
    dws: Tuple[Dw, ...]
    gram: Optional[Tuple[int, int, int, int]]
    scratch: Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]

    def scratch_bytes(self) -> int:
        return sum(_numel(s) * (4 if d == torch.float32 else 2) for _, s, d in self.scratch)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@functools.lru_cache(maxsize=256)
def wide_plan(kind: str, b: int, h: int, w: int, c: int, bands: int = 0,
              frame_h: int = 0) -> WidePlan:
    """The layout of a wide K2 / K3 call giving h rows an image of width w:
    plain (``bands`` 0: x [b, h, w, c], zero padding around the image) or in
    band mode (x [b, h + 4, w, c], each band's 2 halo rows a side from its
    neighbours, the frame's rows [0, frame_h) real). Cached per call shape:
    the wrappers' host time counts beside a ~1 ms call."""
    if kind not in ("gram", "apply"):
        raise ValueError(f"kind must be 'gram' or 'apply', got {kind!r}")
    if c not in WIDE_WIDTHS:
        raise ValueError(f"no wide kernel for C={c}; widths: {WIDE_WIDTHS}")
    if min(b, h, w) < 1:
        raise ValueError(f"empty call: b={b}, h={h}, w={w}")
    band = bands > 0
    if band and not (b % bands == 0 and 1 <= frame_h <= bands * h):
        raise ValueError(f"band mode needs b % bands == 0 and 1 <= frame_h <= bands * h: "
                         f"b={b}, bands={bands}, h={h}, frame_h={frame_h}")
    hin, dz = (h + 4, 1) if band else (h, 0)

    def frame(first: int, rows: int) -> Frame:
        return Frame(bands, h, first, frame_h) if band else Frame(1, 0, 0, rows)

    f32, bf = torch.float32, torch.bfloat16
    if kind == "gram":
        # z on the rows the own rows' dw3x3 reads: band rows -1 .. h.
        first, rows = (1, h + 2) if band else (0, h)
        gz = Gemm(1, b * rows * w, c, 2 * c, False, rows, w, frame(first - 2 * band, rows))
        dw = Dw(b, rows, h, dz, w, 2 * c, "qk", frame(0, h))
        scratch = (("xhat", (b, rows, w, c), bf), ("z", (b, rows, w, 2 * c), f32),
                   ("q", (b, h, w, c), bf), ("k", (b, h, w, c), bf),
                   ("partials", (b, dw.nx, 2 * c), f32), ("gram", (b, c, c), f32))
        return WidePlan(kind, b, hin, h, w, c, ((first, rows),), (gz,), (dw,),
                        (b, h * w, c, c), scratch)
    # K3: v on every input row, y on band rows -1 .. h (so that the FFN's
    # dw3x3 finds its halo), the FFN on the own rows.
    ry = h + 2 if band else h
    gv = Gemm(1, b * hin * w, c, c, False, hin, w, frame(-2 * band, hin))
    dv = Dw(b, hin, ry, dz, w, c, "v")
    gy = Gemm(b, ry * w, c, c, True, ry, w, res_rows=hin, res_dr=dz)
    gt = Gemm(1, b * ry * w, c, 2 * c, False, ry, w, frame(-band, ry))
    df = Dw(b, ry, h, dz, w, 2 * c, "gelu")
    go = Gemm(1, b * h * w, 2 * c, c, False, h, w, res_rows=ry, res_dr=dz)
    scratch = (("xhat", (b, hin, w, c), bf), ("zv", (b, hin, w, c), f32),
               ("v", (b, ry, w, c), bf), ("y", (b, ry, w, c), bf), ("yhat", (b, ry, w, c), bf),
               ("t", (b, ry, w, 2 * c), f32), ("f", (b, h, w, 2 * c), bf))
    return WidePlan(kind, b, hin, h, w, c, ((0, hin), (0, ry)), (gv, gy, gt, go), (dv, df),
                    None, scratch)


# ----------------------------------------------------------------------------
# Plain twins (the kernels' rounding points: bf16 LayerNorm, fp32 z, bf16
# after the dw3x3 and the residual products)
# ----------------------------------------------------------------------------


def layernorm_rows_plain(x: torch.Tensor, first: int, rows: int) -> torch.Tensor:
    """LayerNorm without affine (biased variance, eps 1e-5) of rows [first,
    first + rows) of x [B, HX, W, C] -> bf16 [B, rows, W, C]."""
    v = x[:, first: first + rows].float()
    mu = v.mean(-1, keepdim=True)
    d = v - mu
    return (d * torch.rsqrt((d * d).mean(-1, keepdim=True) + 1e-5)).to(torch.bfloat16)


def gemm_plain(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor, g: Gemm,
               res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gemm``'s function in fp32: [*, rows, w, n] fp32 z, or bf16 with
    the residual."""
    acc = a.reshape(g.g, g.m, g.k).float() @ b.float() + bias.float()
    out = acc.reshape(-1, g.rows, g.w, g.n)
    if res is None:
        return out * g.frame.mask(out.shape[0], g.rows, out.device)
    return (out + res[:, g.res_dr: g.res_dr + g.rows].float()).to(torch.bfloat16)


def dw3x3_plain(z: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, d: Dw):
    """``dw3x3``'s function: "qk" -> (q, k, partials), else bf16 out."""
    lo, hi = d.dz - 1, d.ro + d.dz + 1  # the z rows the output reads
    zp = F.pad(z.float(), (0, 0, 0, 0, max(0, -lo), max(0, hi - d.rz)))
    zp = zp[:, max(0, lo): max(0, lo) + d.ro + 2]
    f = d.f
    a = F.conv2d(zp.permute(0, 3, 1, 2), taps.float().t().reshape(f, 1, 3, 3), bias.float(),
                 padding=(0, 1), groups=f).permute(0, 2, 3, 1)
    if d.epi == "v":
        return a.to(torch.bfloat16).contiguous()
    if d.epi == "gelu":
        return F.gelu(a).to(torch.bfloat16).contiguous()
    v = (a * d.frame.mask(d.b, d.ro, a.device)).to(torch.bfloat16)
    c = f // 2
    sq = F.pad(v.float() ** 2, (0, 0, 0, (-d.w) % DW_COLS, 0, (-d.ro) % DW_ROWS))
    nr, ncg = _cdiv(d.ro, DW_ROWS), _cdiv(d.w, DW_COLS)
    part = sq.reshape(d.b, nr, DW_ROWS, ncg, DW_COLS, f).sum((2, 4)).reshape(d.b, nr * ncg, f)
    return v[..., :c].contiguous(), v[..., c:].contiguous(), part


def gram_finish_plain(gram: torch.Tensor, partials: torch.Tensor) -> torch.Tensor:
    """[B, C*C + 2C]: each image's gram, then its partials' sums."""
    return torch.cat([gram.reshape(gram.shape[0], -1), partials.sum(1)], 1)


# ----------------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, numel: int, dtype: torch.dtype, device) -> None:
    if t.device != device or t.dtype != dtype or t.numel() != numel or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: want {numel} {dtype} contiguous, 16-byte aligned on {device}; "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def layernorm_rows(x: torch.Tensor, first: int, rows: int) -> torch.Tensor:
    """LayerNorm of rows [first, first + rows) of each image of x [B, HX, W,
    C] bf16 -> [B, rows, W, C] bf16. CPU: the twin. CUDA: the kernel."""
    if not x.is_cuda:
        return layernorm_rows_plain(x, first, rows)
    b, hx, w, c = x.shape
    if c not in WIDE_WIDTHS or not 0 <= first <= first + rows <= hx:
        raise ValueError(f"layernorm_rows: C={c}, rows [{first}, {first + rows}) of {hx}")
    _check(x, "x", x.numel(), torch.bfloat16, x.device)
    out = torch.empty((b, rows, w, c), dtype=torch.bfloat16, device=x.device)
    _build.check(_build.library().blle_wide_layernorm(
        x.data_ptr(), out.data_ptr(), b, hx, first, rows, w, c, _build.stream_of(x)),
        "wide LayerNorm pass")
    layernorm_rows.launches += 1
    return out


layernorm_rows.launches = 0


@functools.lru_cache(maxsize=None)
def gemm_info(tn: int) -> Tuple[int, int, int, int]:
    """The library's (shared-memory bytes, threads, ring stages, CTAs an SM)
    of the GEMM of tile width tn."""
    info = (ctypes.c_longlong * 4)()
    _build.check(_build.library().blle_wide_gemm_info(tn, info), f"wide GEMM info (tn={tn})")
    return tuple(info)


@functools.lru_cache(maxsize=1024)
def gemm_ctas(g: Gemm, device_index: int) -> int:
    """The GEMM's persistent grid: the CTAs the card holds at once, at most
    one a tile (cached per product)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return min(g.tiles, gemm_info(g.tn)[3] * sms)


def gemm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor, g: Gemm,
         res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A @ B (+ bias; z: masked by the frame, fp32; with ``res``: plus the
    residual, bf16) of the product ``g``; a, b bf16, bias fp32, res bf16.
    CPU: the twin. CUDA: the kernel."""
    if not a.is_cuda:
        return gemm_plain(a, b, bias, g, res)
    dev = a.device
    nb = (g.g if g.batched else 1) * g.k * g.n
    _check(a, "A", g.g * g.m * g.k, torch.bfloat16, dev)
    _check(b, "B", nb, torch.bfloat16, dev)
    _check(bias, "bias", g.n, torch.float32, dev)
    imgs = g.g * g.m // (g.rows * g.w)
    if res is not None:
        _check(res, "residual", imgs * g.res_rows * g.w * g.n, torch.bfloat16, dev)
    out = torch.empty((imgs, g.rows, g.w, g.n), device=dev,
                      dtype=torch.float32 if res is None else torch.bfloat16)
    fr = g.frame or Frame(1, 0, 0, g.rows)
    table = (ctypes.c_longlong * 20)(
        a.data_ptr(), b.data_ptr(), bias.data_ptr(), 0 if res is None else res.data_ptr(),
        out.data_ptr(), g.g, g.m, g.k, g.n, int(g.batched), g.tn, gemm_ctas(g, dev.index or 0),
        g.rows, g.w, g.res_rows, g.res_dr, fr.bands, fr.hb, fr.first, fr.frame_h)
    _build.check(_build.library().blle_wide_gemm(table, _build.stream_of(a)), "wide GEMM")
    gemm.launches += 1
    return out


gemm.launches = 0


def dw3x3(z: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, d: Dw):
    """The depthwise pass ``d`` on z fp32 (taps [9, f], bias [f] fp32):
    "qk" -> (q, k [b, ro, w, f / 2] bf16, partials [b, nx, f] fp32), "v" /
    "gelu" -> [b, ro, w, f] bf16. CPU: the twin. CUDA: the kernel."""
    if not z.is_cuda:
        return dw3x3_plain(z, taps, bias, d)
    dev = z.device
    _check(z, "z", d.b * d.rz * d.w * d.f, torch.float32, dev)
    _check(taps, "taps", 9 * d.f, torch.float32, dev)
    _check(bias, "bias", d.f, torch.float32, dev)
    qk = d.epi == "qk"
    ch = d.f // 2 if qk else d.f
    out0 = torch.empty((d.b, d.ro, d.w, ch), dtype=torch.bfloat16, device=dev)
    out1 = torch.empty_like(out0) if qk else None
    part = torch.empty((d.b, d.nx, d.f), dtype=torch.float32, device=dev) if qk else None
    fr = d.frame or Frame(1, 0, 0, d.ro)
    _build.check(_build.library().blle_wide_dw(
        z.data_ptr(), taps.data_ptr(), bias.data_ptr(), out0.data_ptr(),
        out1.data_ptr() if qk else 0, part.data_ptr() if qk else 0, d.b, d.rz, d.ro, d.dz, d.w,
        d.f, DW_EPIS.index(d.epi), fr.bands, fr.hb, fr.frame_h, _build.stream_of(z)),
        "wide dw3x3 pass")
    dw3x3.launches += 1
    return (out0, out1, part) if qk else out0


dw3x3.launches = 0


def gram_finish(gram: torch.Tensor, partials: torch.Tensor) -> torch.Tensor:
    """gram [B, C, C] fp32, partials [B, nx, 2C] fp32 -> [B, C*C + 2C] fp32.
    CPU: the twin. CUDA: the kernel."""
    if not gram.is_cuda:
        return gram_finish_plain(gram, partials)
    b, c, nx = gram.shape[0], gram.shape[-1], partials.shape[1]
    _check(gram, "gram", b * c * c, torch.float32, gram.device)
    _check(partials, "partials", b * nx * 2 * c, torch.float32, gram.device)
    out = torch.empty((b, c * c + 2 * c), dtype=torch.float32, device=gram.device)
    _build.check(_build.library().blle_wide_gram_finish(
        gram.data_ptr(), partials.data_ptr(), out.data_ptr(), b, c, nx,
        _build.stream_of(gram)), "wide gram finish")
    gram_finish.launches += 1
    return out


gram_finish.launches = 0

# Every wrapper of this module (and the weight-grad pass the gram takes):
# what one wide K2 / K3 call launches.
WRAPPERS = (layernorm_rows, gemm, dw3x3, gram_finish)


# ----------------------------------------------------------------------------
# The passes
# ----------------------------------------------------------------------------


def gram_pass_wide(x: torch.Tensor, wqk, bqk, dwqk, bdwqk, bands: int = 0,
                   frame_h: int = 0) -> torch.Tensor:
    """K2 at a wide width: x [B, H, W, C] (band mode: [B, hb + 4, W, C]) bf16,
    wqk bf16, the rest fp32 -> [B, C*C + 2C] fp32 (each image's or band's
    gram, then its sums of q^2 and of k^2)."""
    b, hin, w, c = x.shape
    p = wide_plan("gram", b, hin - 4 if bands else hin, w, c, bands, frame_h)
    ((first, rows),), (gz,), (dw,) = p.ln, p.gemms, p.dws
    z = gemm(layernorm_rows(x, first, rows), wqk, bqk, gz)
    q, k, partials = dw3x3(z, dwqk, bdwqk, dw)
    del z
    g, kk, m, n = p.gram
    gram = wgk.weight_grad([(q.view(g, kk, m), k.view(g, kk, n))])[0]
    return gram_finish(gram, partials)


def apply_pass_wide(x: torch.Tensor, apply: torch.Tensor, wv, bv, dwv, bdwv, bproj, wp1, bp1,
                    dwf, bdwf, wp2, bp2, bands: int = 0, frame_h: int = 0) -> torch.Tensor:
    """K3 at a wide width: x [B, H, W, C] (band mode: [B, hb + 4, W, C]) bf16,
    apply [B, C, C] and the matrices bf16, the rest fp32 -> [B, H (hb), W, C]
    bf16."""
    b, hin, w, c = x.shape
    p = wide_plan("apply", b, hin - 4 if bands else hin, w, c, bands, frame_h)
    (f1, r1), (f2, r2) = p.ln
    gv, gy, gt, go = p.gemms
    dv, df = p.dws
    zv = gemm(layernorm_rows(x, f1, r1), wv, bv, gv)
    v = dw3x3(zv, dwv, bdwv, dv)
    del zv
    y = gemm(v, apply, bproj, gy, res=x)
    del v
    t = gemm(layernorm_rows(y, f2, r2), wp1, bp1, gt)
    f = dw3x3(t, dwf, bdwf, df)
    del t
    return gemm(f, wp2, bp2, go, res=y)
