"""Peak host memory of the port's AVIF read of a flat frame at and below
libavif's 16384 x 16384 limit, at 8 and 10 bits.

Write the files (needs PIL; PIL's default AVIF save of a flat RGB picture,
the same file rewritten to 10 bits by tests/torch_avif_depth.py, and PIL's
decode of each as the expected colour in a .json beside it):

    PYTHONPATH=. python tests/torch_avif_peak_memory.py --write DIR 8200 16384

Read one (the port only, on the CPU; one file per process, so that each
peak is its own):

    PYTHONPATH=. python tests/torch_avif_peak_memory.py DIR/flat_16384_10.avif

prints one JSON line: the side, the bit depth, seconds of the read, the
resident set after the imports and the process's peak resident set
(ru_maxrss), and whether every pixel is PIL's colour. The read is
assets/avif.read_avif without its decompression-bomb check: load_image,
like the JAX package's through PIL's Image.open, refuses a 16384^2 file
as a decompression bomb.
"""

import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

COLOR = (120, 60, 200)


def _rss_kib() -> int:
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1])
    return -1


def write(folder: Path, sides: list) -> None:
    from PIL import Image
    from torch_avif_depth import to_depth
    # Image.open refuses more than 2 * 89,478,485 pixels (PIL's
    # decompression bomb check, 16384^2 among them); lifted to read the
    # expected colour
    Image.MAX_IMAGE_PIXELS = None
    folder.mkdir(parents=True, exist_ok=True)
    for n in sides:
        a = np.empty((n, n, 3), np.uint8)
        a[...] = COLOR
        path = folder / f"flat_{n}.avif"
        Image.fromarray(a).save(path)
        del a
        (folder / f"flat_{n}_10.avif").write_bytes(
            to_depth(path.read_bytes(), 10))
        for name, depth in ((f"flat_{n}", 8), (f"flat_{n}_10", 10)):
            p = folder / f"{name}.avif"
            with Image.open(p) as im:
                rgba = np.asarray(im.convert("RGBA"))
            color = rgba[0, 0].tolist()
            assert (rgba == rgba[0, 0]).all(), "PIL's decode is not flat"
            del rgba
            (folder / f"{name}.json").write_text(
                json.dumps({"side": n, "depth": depth, "rgba": color}))
            print(p, p.stat().st_size, "bytes, PIL decodes", color,
                  flush=True)


def read(path: Path) -> dict:
    from plainrenderer_tpu_torch.assets import avif
    want = json.loads(path.with_suffix(".json").read_text())
    base = _rss_kib()
    t = time.perf_counter()
    img = avif.read_avif(path.read_bytes(), str(path), check=None)
    seconds = time.perf_counter() - t
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    n = want["side"]
    ok = img.shape == (n, n, 4) and bool(
        (img.reshape(-1, 4) == np.array(want["rgba"], np.uint8)).all())
    return {"side": n, "depth": want.get("depth", 8),
            "load_s": round(seconds, 1),
            "rss_after_imports_mib": round(base / 1024),
            "peak_rss_mib": round(peak / 1024), "equals_pil": ok}


def main(argv: list) -> int:
    if argv[:1] == ["--write"]:
        write(Path(argv[1]), [int(s) for s in argv[2:]])
        return 0
    out = read(Path(argv[0]))
    print(json.dumps(out), flush=True)
    return 0 if out["equals_pil"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
