"""What the wrappers of the kernels on the wgmma GEMM core
(``tpudepth_torch/csrc/gemm_sm90.cuh``), of the GUB conv kernels and of the
training attention compute in Python, on the CPU: the row chunks of
``mlp_train_bwd``'s weight gradients, the scratch the wrappers allocate
(that of the row kernels and of both whole-block kernels too, whose bf16
projections and tails run on the core), the constants they share with the
CUDA sources (the bf16 forward attention's blocks a call too), and the
ctypes signatures they give the C entries (the loss kernels' too). The kernels themselves run only on the card
(``tests/test_torch_port_cuda.py``).
"""

import ctypes
import re

import pytest

from tpudepth_torch.ops.kernels import _build
from tpudepth_torch.ops.kernels import block_infer as bi
from tpudepth_torch.ops.kernels import epilogue_infer as ei
from tpudepth_torch.ops.kernels import fused_loss as fl
from tpudepth_torch.ops.kernels import fused_root_loss as frl
from tpudepth_torch.ops.kernels import gub_conv as gc
from tpudepth_torch.ops.kernels import mlp_train as mt
from tpudepth_torch.ops.kernels import rowblock_infer as rbi
from tpudepth_torch.ops.kernels import window_attn as wat
from tpudepth_torch.ops.kernels import window_attn_infer as wai

# (M, rows, cols) of the weight gradients: dw1 [C, 4C] and dw2 [4C, C] of the
# four stages of a 480x640 batch-8 step, batch 1, and small or ragged M
WGRAD_SHAPES = [(m * b, r, c)
                for m, cc in ((300, 1024), (1200, 512), (4800, 256),
                              (19200, 128))
                for b in (1, 8)
                for r, c in ((cc, 4 * cc), (4 * cc, cc))] + [
    (1, 64, 256), (37, 32, 128), (4999, 128, 512), (64, 96, 384),
    (65, 96, 384)]


def _source(name: str) -> str:
    return (_build.SRC_DIR / name).read_text()


@pytest.mark.parametrize("m,rows,cols", WGRAD_SHAPES,
                         ids=lambda v: str(v))
def test_wgrad_chunk_covers_the_rows_in_whole_k_blocks(m, rows, cols):
    k = mt.wgrad_chunk(m, rows, cols)
    chunks = -(-m // k)
    tiles = -(-rows // 128) * -(-cols // 128)
    # whole 64-row k-blocks (so also multiples of 32); every row in one chunk
    assert k % mt.K_BLOCK == 0 and k % 32 == 0 and k > 0
    assert (chunks - 1) * k < m <= chunks * k
    # one chunk once the product alone fills the SMs; never more tiles than
    # SMs from splitting
    if tiles >= mt.SMS:
        assert chunks == 1
    assert chunks == 1 or chunks * tiles <= mt.SMS
    # a function of the shape alone
    assert mt.wgrad_chunk(m, rows, cols) == k


@pytest.mark.parametrize("m", [1, 37, 63, 64])
def test_wgrad_chunk_takes_small_m_in_one_chunk(m):
    """Up to one k-block of rows there is nothing to split."""
    for rows, cols in ((1024, 4096), (128, 512), (32, 128)):
        assert mt.wgrad_chunk(m, rows, cols) == mt.K_BLOCK


@pytest.mark.parametrize("m,c,hidden,c2", [
    (2400, 1024, 4096, 1024), (153600, 128, 512, 128), (37, 32, 128, 32),
    (4999, 128, 512, 96)])
def test_bwd_scratch_shapes(m, c, hidden, c2):
    shapes = mt.bwd_scratch_shapes(m, c, hidden, c2)
    assert shapes["a"] == shapes["dh"] == (m, hidden)
    assert shapes["db1_part"] == (-(-m // mt.ROW_TILE), hidden)
    assert shapes["db2_part"] == (-(-m // mt.COLSUM_ROWS), c2)
    for key, (r, n) in (("dw1_part", (c, hidden)), ("dw2_part", (hidden, c2))):
        chunks = -(-m // mt.wgrad_chunk(m, r, n))
        assert shapes[key] == ((chunks, r, n) if chunks > 1 else None)


def test_bwd_scratch_has_partials_only_where_the_rows_are_split():
    # crf3 at batch 8: 256 tiles of dw1 fill the SMs, one chunk
    assert mt.bwd_scratch_shapes(2400, 1024, 4096, 1024)["dw1_part"] is None
    # crf0 at batch 8: 4 tiles, 33 chunks of rows
    assert mt.bwd_scratch_shapes(153600, 128, 512, 128)["dw1_part"] == (
        33, 128, 512)


@pytest.mark.parametrize("m,c,hidden", [
    (2400, 1024, 4096), (9600, 512, 2048), (38400, 256, 1024),
    (153600, 128, 512), (37, 32, 128), (200, 96, 384)])
def test_epilogue_scratch_shapes(m, c, hidden):
    shapes = ei.epilogue_scratch_shapes(m, c, hidden)
    assert list(shapes) == ["y", "yn", "g"]
    assert shapes["y"] == shapes["yn"] == (m, c)
    assert shapes["g"] == (m, hidden)


@pytest.mark.parametrize("m,hidden", [
    (2400, 4096), (9600, 2048), (38400, 1024), (153600, 512), (153597, 512),
    (1, 128), (37, 128), (333, 384), (130, 96)])
def test_ffn_scratch_shapes(m, hidden):
    """The bf16 FFN chain's one scratch, the rounded hidden; the block tail's
    chain holds the same tensor as its g."""
    shapes = ei.ffn_scratch_shapes(m, hidden)
    assert shapes == {"g": (m, hidden)}
    assert ei.epilogue_scratch_shapes(m, 64, hidden)["g"] == shapes["g"]


_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float, "long long": ctypes.c_longlong,
            # arrays: one pointer a part, one int a part, strides
            "void**": ctypes.POINTER(ctypes.c_void_p),
            "int*": ctypes.POINTER(ctypes.c_int),
            "long long*": ctypes.POINTER(ctypes.c_longlong)}


def _c_entries(source: str) -> dict:
    """``{name: [ctypes type of each parameter]}`` of the ``extern "C"``
    functions of a CUDA source, read from their declarations. A pointer to
    data (void, float, ...) is a c_void_p; a pointer to pointers, to ints or
    to long longs is a ctypes pointer of that type; ``()`` takes none."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                   _source(source)):
        types = []
        for param in filter(str.strip, params.split(",")):
            words = param.replace("const", " ").replace("*", " * ").split()
            stars = words.count("*")
            decl = " ".join(w for w in words[:-1] if w != "*")
            if stars == 2:
                decl = "void**"
            elif stars == 1:
                decl = f"{decl}*" if decl in ("int", "long long") else "void*"
            types.append(_C_TYPES[decl])
        out[name] = types
    return out


# (CUDA source, the ctypes signatures its wrapper module sets)
_SIGNATURES = {
    "epilogue_infer": ("epilogue_infer.cu", ei.ARGTYPES),
    "mlp_train": ("mlp_train.cu", mt.ARGTYPES),
    "gub_conv_fwd": ("gub_conv_fwd.cu", gc.ARGTYPES["gub_conv_fwd"]),
    "gub_conv_bwd": ("gub_conv_bwd.cu", gc.ARGTYPES["gub_conv_bwd"]),
    "rowblock_infer": ("rowblock_infer.cu", rbi.ARGTYPES),
    "block_infer": ("block_infer.cu", bi.ARGTYPES),
    "window_attn_train": ("window_attn_train.cu", wat.ARGTYPES),
    "fused_loss": ("fused_loss.cu", fl.ARGTYPES),
    "fused_root_loss": ("fused_root_loss.cu", frl.ARGTYPES),
}


@pytest.mark.parametrize("source,argtypes", list(_SIGNATURES.values()),
                         ids=list(_SIGNATURES))
def test_every_c_entry_has_a_ctypes_signature(source, argtypes):
    assert sorted(_c_entries(source)) == sorted(argtypes)


_ENTRIES = [("epilogue_infer", "block_epilogue_infer"),
            ("epilogue_infer", "mlp_infer"),
            ("mlp_train", "mlp_train_fwd"),
            ("mlp_train", "mlp_train_bwd"),
            ("gub_conv_fwd", "gub_conv_fwd"),
            ("gub_conv_bwd", "gub_conv_bwd_tiles"),
            ("gub_conv_bwd", "gub_conv_dw_blocks"),
            ("gub_conv_bwd", "gub_conv_dw"),
            ("gub_conv_bwd", "gub_conv_dx"),
            ("rowblock_infer", "crf_rowblock_infer"),
            ("rowblock_infer", "sam_rowblock_infer"),
            ("block_infer", "crf_block_infer"),
            ("block_infer", "sam_block_infer"),
            ("window_attn_train", "window_attn_train_fwd"),
            ("window_attn_train", "window_attn_train_bwd"),
            ("fused_loss", "fused_loss_fwd_tile"),
            ("fused_loss", "fused_loss_fwd"),
            ("fused_loss", "fused_loss_bwd"),
            ("fused_root_loss", "fused_root_loss_fwd_strip"),
            ("fused_root_loss", "fused_root_loss_fwd"),
            ("fused_root_loss", "fused_root_loss_bwd")]


@pytest.mark.parametrize("library,name", _ENTRIES, ids=[
    f"{_SIGNATURES[lib][0]}--{name}" for lib, name in _ENTRIES])
def test_ctypes_signature_matches_the_c_entry(library, name):
    """Parameter for parameter: a pointer to data is a c_void_p, an int a
    c_int, an array a ctypes pointer of its type (a mismatch shows only on
    the card, as a wrong argument)."""
    source, argtypes = _SIGNATURES[library]
    assert list(argtypes[name]) == _c_entries(source)[name]


def _constants(source: str, names) -> list:
    """The values of ``constexpr int NAME = <int>;`` in a CUDA source (the
    first of each name, or the first inside ``namespace fwd`` of the
    alhashim loss, whose backward has constants of the same names)."""
    text = _source(source)
    if "namespace fwd {" in text:
        text = text[text.index("namespace fwd {"):text.index("}  // namespace fwd")]
    return [int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
            for n in names]


@pytest.mark.parametrize("h,w", [(480, 640), (33, 65), (2, 3)])
def test_fused_loss_fwd_scratch_matches_the_cuda_source(h, w):
    """The forward's scratch: a block a 40x64 tile of ``fused_loss.cu``'s
    ``namespace fwd``, three sums a block, then one ticket counter an
    image (the C entry refuses a smaller scratch)."""
    th, tw = _constants("fused_loss.cu", ("TH", "TW"))
    assert (th, tw) == (40, 64)
    for bsz in (1, 8):
        blocks = -(-h // th) * -(-w // tw)
        words = fl.fwd_scratch_words(bsz, h, w, (th, tw))
        assert words == bsz * blocks * 3 + bsz
        # the counters come after the sums, one an image
        assert words - fl.fwd_scratch_words(bsz - 1, h, w, (th, tw)) == (
            blocks * 3 + 1)


@pytest.mark.parametrize("h,w", [(480, 640), (33, 65), (2, 3)])
def test_fused_root_loss_fwd_scratch_matches_the_cuda_source(h, w):
    """The forward's scratch: warp strips of ``FWD_ROWS`` x ``FWD_COLS``
    outputs (from column -1, so ``ceil((W + 1) / FWD_COLS)`` a row),
    ``FWD_WARPS`` strips a block, two sums a block, then one ticket counter
    an image (the C entry refuses a smaller scratch)."""
    rows, cols, warps = _constants("fused_root_loss.cu",
                                   ("FWD_ROWS", "FWD_COLS", "FWD_WARPS"))
    assert (rows, cols, warps) == (8, 62, 4)
    for bsz in (1, 8):
        strips = -(-h // rows) * ((w + cols) // cols)
        blocks = -(-strips // warps)
        words = frl.fwd_scratch_words(bsz, h, w, (rows, cols, warps))
        assert words == bsz * blocks * 2 + bsz
        assert words - frl.fwd_scratch_words(bsz - 1, h, w,
                                             (rows, cols, warps)) == (
            blocks * 2 + 1)


def test_ffn_entries_share_one_signature_with_the_bf16_scratch():
    """``mlp_infer`` and ``mlp_train_fwd`` take x, w1, b1, w2, b2, out and
    the bf16 scratch g: seven pointers, five ints, the stream."""
    assert ei.ARGTYPES["mlp_infer"] == mt.ARGTYPES["mlp_train_fwd"] == (
        ei.FFN_ARGTYPES)
    assert ei.FFN_ARGTYPES == (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5 + (
        ctypes.c_void_p,)


def test_python_constants_match_the_cuda_sources():
    core = _source("gemm_sm90.cuh")
    assert int(re.search(r"constexpr int kBK = (\d+);", core).group(1)) == (
        mt.K_BLOCK)
    assert int(re.search(r"constexpr int kBM = (\d+);", core).group(1)) == (
        mt.ROW_TILE)
    mlp = _source("mlp_train.cu")
    assert int(re.search(r"constexpr int kColsumRows = (\d+);", mlp).group(1)
               ) == mt.COLSUM_ROWS


def test_forward_attention_blocks_match_the_cuda_source():
    """The bf16 forward's launch computes its chunk of windows in C
    (``wattn::fwd_chunk``); the wrapper's mirror has its constant, and
    chunks are the shortest that keep the blocks within ``FWD_BLOCKS``."""
    attn = _source("window_attn.cuh")
    assert int(re.search(r"constexpr int kFwdBlocks = (\d+);", attn).group(1)
               ) == wai.FWD_BLOCKS
    for bw, heads in ((3312, 4), (864, 8), (240, 16), (72, 32), (9, 32),
                      (259, 8), (1, 1)):
        chunk = wai.fwd_chunk(bw, heads)
        blocks = -(-bw // chunk) * heads
        assert 1 <= chunk <= bw
        assert blocks <= max(wai.FWD_BLOCKS, heads)
        assert chunk == 1 or -(-bw // (chunk - 1)) * heads > wai.FWD_BLOCKS


# (B, Hp, Wp, C) of SAM's four stages at 480x640, batch 1 and 8 (the maps
# padded to multiples of 7), and an odd geometry (M = 2 * 14 * 21 = 588)
SAM_ROW_SHAPES = [(b, -(-h // 7) * 7, -(-w // 7) * 7, c)
                  for b in (1, 8)
                  for c, (h, w) in ((1024, (15, 20)), (512, (30, 40)),
                                    (256, (60, 80)), (128, (120, 160)))] + [
    (2, 14, 21, 32)]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,hp,wp,c", SAM_ROW_SHAPES, ids=lambda v: str(v))
def test_sam_row_scratch_shapes(b, hp, wp, c, bf16):
    """q, k and v side by side; in bf16 the tail chain's y and yn fit in
    their first 2 M C elements and its hidden g [M, 4C] has its own."""
    shapes = rbi.sam_scratch_shapes(b, hp, wp, c, 4 * c, bf16)
    assert list(shapes) == ["qkv", "g"]
    assert shapes["qkv"] == (b, hp, wp, 3 * c)
    m = b * hp * wp
    if not bf16:
        assert shapes["g"] is None
        return
    assert shapes["g"] == (m, 4 * c)
    assert ei.epilogue_scratch_shapes(m, c, 4 * c)["g"] == shapes["g"]
    y_yn = sum(s[0] * s[1] for k, s in
               ei.epilogue_scratch_shapes(m, c, 4 * c).items() if k != "g")
    assert y_yn == 2 * m * c <= m * 3 * c


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,hp,wp,c", SAM_ROW_SHAPES, ids=lambda v: str(v))
def test_crf_row_scratch_shapes(b, hp, wp, c, bf16):
    """q and k side by side; in bf16 the tail chain's y and yn take all of
    their 2 M C elements and its hidden g [M, 4C] has its own."""
    shapes = rbi.crf_scratch_shapes(b, hp, wp, c, 4 * c, bf16)
    assert list(shapes) == ["qk", "g"]
    assert shapes["qk"] == (b, hp, wp, 2 * c)
    m = b * hp * wp
    if not bf16:
        assert shapes["g"] is None
        return
    chain = ei.epilogue_scratch_shapes(m, c, 4 * c)
    assert shapes["g"] == chain["g"] == (m, 4 * c)
    y_yn = sum(s[0] * s[1] for k, s in chain.items() if k != "g")
    assert y_yn == shapes["qk"][0] * hp * wp * shapes["qk"][3]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,hp,wp,c", SAM_ROW_SHAPES, ids=lambda v: str(v))
def test_sam_block_scratch_shapes(b, hp, wp, c, bf16):
    """The same map as window-major rows (BW windows of 49 tokens): q, k and
    v side by side; in bf16 the whole-block chain's f32 y (4 M C bytes) and
    bf16 yn (2 M C) fill qkv's 6 M C bytes, yn starting 16-byte aligned,
    and its hidden g [M, 4C] in bf16 has its own."""
    bw = b * (hp // 7) * (wp // 7)
    shapes = bi.sam_scratch_shapes(bw, 49, c, 4 * c, bf16)
    assert list(shapes) == ["qkv", "g"]
    assert shapes["qkv"] == (bw, 49, 3 * c)
    m = bw * 49
    assert m == b * hp * wp
    if not bf16:
        assert shapes["g"] is None
        return
    assert shapes["g"] == (m, 4 * c)
    qkv_bytes = 2 * bw * 49 * shapes["qkv"][2]
    y_bytes, yn_bytes = 4 * m * c, 2 * m * c
    assert y_bytes + yn_bytes == qkv_bytes
    assert y_bytes % 16 == 0


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,hp,wp,c", SAM_ROW_SHAPES, ids=lambda v: str(v))
def test_crf_block_scratch_shapes(b, hp, wp, c, bf16):
    """The same map as window-major rows: q and k side by side; in bf16 the
    whole-block chain's f32 y (4 M C bytes) fills all of qk's bytes, its
    bf16 yn (2 M C) fits the output buffer [BW, 49, C], and its hidden g
    [M, 4C] in bf16 has its own."""
    bw = b * (hp // 7) * (wp // 7)
    shapes = bi.crf_scratch_shapes(bw, 49, c, 4 * c, bf16)
    assert list(shapes) == ["qk", "g"]
    assert shapes["qk"] == (bw, 49, 2 * c)
    m = bw * 49
    if not bf16:
        assert shapes["g"] is None
        return
    assert shapes["g"] == (m, 4 * c)
    assert 4 * m * c == 2 * bw * 49 * shapes["qk"][2]
    assert 2 * m * c == 2 * bw * 49 * c


def test_crf_block_entry_takes_the_hidden_scratch():
    """``crf_block_infer`` takes g beside qk: one pointer more than before
    the tail moved onto the core, in the place ``sam_block_infer`` has it
    (just before out)."""
    params = re.search(r'extern "C" int crf_block_infer\(([^)]*)\)',
                       _source("block_infer.cu")).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[names.index("qk"):names.index("out") + 1] == [
        "qk", "g", "out"]
    assert bi.ARGTYPES["crf_block_infer"][:20] == (ctypes.c_void_p,) * 20
