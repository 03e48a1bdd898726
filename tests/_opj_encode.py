"""A JPEG 2000 encoder for tests: openjpeg 2.5's, the copy PIL ships beside
itself (`site-packages/pillow.libs/libopenjp2-*.so.*`), driven through
ctypes for what PIL's save options never write: code-block styles, SOP and
EPH markers, sub-sampled components, RGN, POC and colour spaces other than
PIL's. Only tests import it; the port never does.

    data = encode([y, cb, cr], dx=(1, 2, 2), dy=(1, 2, 2), fmt="jp2",
                  colour="sycc", style=0x3F, sop=True, eph=True)

Each plane is a (h, w) array of one component's samples at its own size
(ceil(W / dx) x ceil(H / dy) for an image of W x H at offset 0). The
offsets into openjpeg's structs are those of openjpeg 2.5 on a 64-bit
host (opj_cparameters_t, opj_image_t, opj_image_comp_t)."""

import ctypes
import glob
import os
import tempfile

import numpy as np
import PIL
from PIL import Image

# opj_cparameters_t: the first field of each run written at once
_P_TILE = 0                                 # tile_size_on, cp_tx0, cp_ty0, cp_tdx, cp_tdy
_P_DISTO_ALLOC = 20
_P_CSTY = 48                                # csty, prog_order
_P_POC, _POC_SIZE = 56, 148                 # opj_poc_t POC[32]
_P_NUMPOCS, _P_NUMLAYERS, _P_RATES = 4792, 4796, 4800
_P_NUMRES = 5600                            # numresolution, cblockw_init, cblockh_init
_P_MODE = 5612                              # mode (the code-block style), irreversible
_P_ROI = 5620                               # roi_compno, roi_shift
_P_RES_SPEC, _P_PRCW, _P_PRCH = 5628, 5632, 5764
_P_IMG_OFFSET = 18188                       # image_offset_x0, image_offset_y0
_P_TCP_MCT = 18698
# opj_poc_t: resno0, compno0, layno1, resno1, compno1, layno0, precno0,
# precno1, prg1, prg, progorder[5], tile
_POC_PRG1, _POC_TILE = 32, 48
_PROGS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
_COLOURS = {"unspecified": 0, "srgb": 1, "grey": 2, "sycc": 3, "eycc": 4, "cmyk": 5}


def library() -> ctypes.CDLL:
    """PIL's bundled libopenjp2; a clear error where it is missing."""
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, "libopenjp2*.so*")))
    if not found:
        raise RuntimeError(f"no libopenjp2 beside PIL in {libs}: the JPEG 2000 fixtures of "
                           f"these tests are written by the openjpeg PIL ships")
    lib = ctypes.CDLL(found[0])
    vp = ctypes.c_void_p
    lib.opj_image_create.restype = vp
    lib.opj_image_create.argtypes = [ctypes.c_uint32, vp, ctypes.c_int]
    lib.opj_create_compress.restype = vp
    lib.opj_setup_encoder.argtypes = [vp, vp, vp]
    lib.opj_stream_create_default_file_stream.restype = vp
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.opj_start_compress.argtypes = [vp, vp, vp]
    lib.opj_encode.argtypes = [vp, vp]
    lib.opj_end_compress.argtypes = [vp, vp]
    lib.opj_stream_destroy.argtypes = [vp]
    lib.opj_destroy_codec.argtypes = [vp]
    lib.opj_image_destroy.argtypes = [vp]
    return lib


def _put(buf, offset, fmt, *values):
    np.frombuffer(buf, fmt, len(values), offset)[:] = values


def encode(planes, dx=None, dy=None, *, fmt="jp2", prec=8, sgnd=False, colour=None,
           irreversible=False, mct=0, numres=3, cblk=(64, 64), rates=(0,), prog="LRCP",
           style=0, sop=False, eph=False, precincts=None, tiles=None, roi=None, pocs=(),
           offset=(0, 0), size=None) -> bytes:
    """The planes encoded by openjpeg; `rates` are the layers' compression
    ratios (0: lossless), `roi` (component, shift), `pocs` a list of
    (resno0, compno0, layno1, resno1, compno1, progression) for tile 1,
    `precincts` [(w, h)] from the highest resolution down."""
    lib = library()
    nc = len(planes)
    dx = dx or (1,) * nc
    dy = dy or (1,) * nc
    x0, y0 = offset
    width, height = size or (planes[0].shape[1] * dx[0], planes[0].shape[0] * dy[0])
    x1, y1 = x0 + width, y0 + height
    for p, a, b in zip(planes, dx, dy):
        if p.shape != (-(-y1 // b) + (-y0 // b), -(-x1 // a) + (-x0 // a)):
            raise ValueError(f"plane {p.shape} is not ceil(size / subsampling)")
    cmpt = np.zeros((nc, 9), np.uint32)
    for i, (p, a, b) in enumerate(zip(planes, dx, dy)):
        cmpt[i] = (a, b, p.shape[1], p.shape[0], -(-x0 // a), -(-y0 // b), prec, prec,
                   int(sgnd))
    if colour is None:
        colour = "grey" if nc <= 2 else "srgb"
    image = lib.opj_image_create(nc, cmpt.ctypes.data, _COLOURS[colour])
    if not image:
        raise RuntimeError("opj_image_create failed")
    codec = stream = None
    path = None
    try:
        ctypes.memmove(image, np.array([x0, y0, x1, y1], np.uint32).ctypes.data, 16)
        comps = ctypes.c_void_p.from_address(image + 24).value
        for i, p in enumerate(planes):
            data = ctypes.c_void_p.from_address(comps + 64 * i + 48).value
            src = np.ascontiguousarray(p, np.int32)
            ctypes.memmove(data, src.ctypes.data, src.nbytes)
        params = bytearray(65536)
        pbuf = (ctypes.c_char * len(params)).from_buffer(params)
        lib.opj_set_default_encoder_parameters(pbuf)
        _put(params, _P_DISTO_ALLOC, np.int32, 1)
        _put(params, _P_NUMLAYERS, np.int32, len(rates))
        _put(params, _P_RATES, np.float32, *rates)
        _put(params, _P_NUMRES, np.int32, numres, *cblk)
        _put(params, _P_MODE, np.int32, style, int(irreversible))
        _put(params, _P_CSTY, np.int32, (2 if sop else 0) | (4 if eph else 0)
             | (1 if precincts else 0), _PROGS[prog])
        _put(params, _P_IMG_OFFSET, np.int32, x0, y0)
        params[_P_TCP_MCT] = mct
        if precincts:
            _put(params, _P_RES_SPEC, np.int32, len(precincts))
            _put(params, _P_PRCW, np.int32, *[w for w, _ in precincts])
            _put(params, _P_PRCH, np.int32, *[h for _, h in precincts])
        if tiles:
            tw, th, tx0, ty0 = tiles
            _put(params, _P_TILE, np.int32, 1, tx0, ty0, tw, th)
        if roi:
            _put(params, _P_ROI, np.int32, *roi)
        for i, (r0, c0, l1, r1, c1, pg) in enumerate(pocs):
            at = _P_POC + i * _POC_SIZE
            _put(params, at, np.uint32, r0, c0, l1, r1, c1)
            _put(params, at + _POC_PRG1, np.int32, _PROGS[pg])
            _put(params, at + _POC_TILE, np.uint32, 1)
        _put(params, _P_NUMPOCS, np.uint32, len(pocs))
        codec = lib.opj_create_compress(2 if fmt == "jp2" else 0)
        if not lib.opj_setup_encoder(codec, pbuf, image):
            raise RuntimeError("opj_setup_encoder failed")
        fd, path = tempfile.mkstemp(suffix="." + fmt)
        os.close(fd)
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        if not (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
                and lib.opj_end_compress(codec, stream)):
            raise RuntimeError("openjpeg failed to encode")
        lib.opj_stream_destroy(stream)
        stream = None
        with open(path, "rb") as f:
            return f.read()
    finally:
        if stream:
            lib.opj_stream_destroy(stream)
        if codec:
            lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
        if path:
            os.unlink(path)


def ycc420_styles(rgb) -> bytes:
    """`rgb`'s YCbCr (PIL's conversion), its chroma at every second row and
    column, as a JP2 of colr 18 with every code-block style, SOP and EPH
    markers and two layers (the last lossless)."""
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    return encode([ycc[..., 0], ycc[::2, ::2, 1], ycc[::2, ::2, 2]], (1, 2, 2), (1, 2, 2),
                  colour="sycc", style=0x3F, sop=True, eph=True, rates=(4, 0), numres=2)
