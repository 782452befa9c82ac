"""Peak host memory of the port's AVIF read of a flat frame at and below
libavif's 16384 x 16384 limit.

Write the files (needs PIL; PIL's default AVIF save of a flat RGB picture,
and PIL's decode of it as the expected colour in a .json beside it; the
JAX package's load_image, through PIL's Image.open, refuses a 16384^2
file as a decompression bomb):

    PYTHONPATH=. python tests/torch_avif_peak_memory.py --write DIR 8200 16384

Read one (the port only, on the CPU; one file per process, so that each
peak is its own):

    PYTHONPATH=. python tests/torch_avif_peak_memory.py DIR/flat_16384.avif

prints one JSON line: the side, seconds of load_image, the resident set
after the imports and the process's peak resident set (ru_maxrss), and
whether every pixel is PIL's colour.
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
        with Image.open(path) as im:
            rgba = np.asarray(im.convert("RGBA"))
        color = rgba[0, 0].tolist()
        assert (rgba == rgba[0, 0]).all(), "PIL's decode is not flat"
        (folder / f"flat_{n}.json").write_text(
            json.dumps({"side": n, "rgba": color}))
        print(path, path.stat().st_size, "bytes, PIL decodes", color,
              flush=True)


def read(path: Path) -> dict:
    from plainrenderer_tpu_torch.assets import image_io
    want = json.loads(path.with_suffix(".json").read_text())
    base = _rss_kib()
    t = time.perf_counter()
    img = image_io.load_image(path)
    seconds = time.perf_counter() - t
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    n = want["side"]
    ok = img.shape == (n, n, 4) and bool(
        (img.reshape(-1, 4) == np.array(want["rgba"], np.uint8)).all())
    return {"side": n, "load_s": round(seconds, 1),
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
