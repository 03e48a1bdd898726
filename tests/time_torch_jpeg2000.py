"""Decode times of 612x816 JPEG 2000 photos at realistic rates through the
port's `data/jpeg2000.py`, with the share its C++ tier 1 takes.

    python3 tests/time_torch_jpeg2000.py [--reps 5]

The streams are made at run time with PIL's encoder from the camera image of
`synth_polar_scene` (seed 15, as the committed `photo_612x816.jp2`) with a
sensor's noise added (Gaussian, 4 levels; the scene alone is so smooth that
its 9/7 stream, uncapped, is about 110:1, and 10:1 is never reached):
lossless (5/3 with the colour transform, as opj_compress writes RGB by
default) and 9/7 at 10:1 (one layer, with the colour transform), beside the
committed 200:1 photo. For each stream one JSON line: its bytes, its
code-blocks, the median ms of `decode_jpeg2000`, of `tier1_inputs` (the
headers and tier 2) and of `tier1` (the C++ tier 1) alone, tier 1's share of
the decode, PIL's `Image.open(...).convert("RGB")` ms, and whether the
port's pixels equal PIL's. It exits non-zero where they differ.
"""

import argparse
import io
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from shmgan_tpu_torch.data import jpeg2000  # noqa: E402

PHOTO = os.path.join(REPO, "tests", "data", "torch_codecs", "photo_612x816.jp2")
NOISE = 4.0             # the sensor noise's standard deviation, in levels
# name -> PIL's save options
STREAMS = {
    "lossless_53_mct": dict(mct=1),
    "rate10_97_mct": dict(irreversible=True, mct=1, quality_mode="rates", quality_layers=[10]),
}


def _streams():
    """{name: stream}, made with PIL's encoder."""
    from PIL import Image

    from shmgan_tpu_torch.data.synthetic import camera_image, synth_polar_scene

    views, diffuse, _ = synth_polar_scene(np.random.default_rng(15), 612, 816)
    rng = np.random.default_rng(16)
    photo = camera_image(diffuse, views) * 255 + rng.normal(0, NOISE, (612, 816, 3))
    im = Image.fromarray(np.clip(np.rint(photo), 0, 255).astype(np.uint8))
    out = {}
    for name, opts in STREAMS.items():
        buf = io.BytesIO()
        im.save(buf, format="JPEG2000", **opts)
        out[name] = buf.getvalue()
    with open(PHOTO, "rb") as f:
        out["committed_rate200_97_3layers"] = f.read()
    return out


def _pil_rgb(data):
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.ascontiguousarray(im.convert("RGB"))


def _median_ms(fn, reps):
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    streams = _streams()
    jpeg2000.decode_jpeg2000(next(iter(streams.values())))      # builds tier 1
    ok = True
    for name, data in streams.items():
        rgb = jpeg2000.decode_jpeg2000(data)
        blocks = jpeg2000.tier1_inputs(data)
        row = {
            "stream": name, "bytes": len(data),
            "ratio": round(rgb.size / len(data), 2), "shape": list(rgb.shape),
            "code_blocks": len(blocks),
            "decode_ms": _median_ms(lambda: jpeg2000.decode_jpeg2000(data), args.reps),
            "headers_tier2_ms": _median_ms(lambda: jpeg2000.tier1_inputs(data), args.reps),
            "tier1_ms": _median_ms(lambda: jpeg2000.tier1(blocks), args.reps),
            "pil_ms": _median_ms(lambda: _pil_rgb(data), args.reps),
            "equal_to_pil": bool(np.array_equal(rgb, _pil_rgb(data))), "reps": args.reps,
        }
        row["tier1_share"] = round(row["tier1_ms"] / row["decode_ms"], 3)
        ok &= row["equal_to_pil"]
        print(json.dumps(row), flush=True)
    if not ok:
        raise SystemExit("a stream decoded otherwise than PIL")


if __name__ == "__main__":
    main()
