"""The courtyard's AVIF textures (tests/data/formats_avif/courtyard, PIL's
default saves, and tests/data/formats_avif_matrix/courtyard_ycgco, YCgCo
4:2:0 files libavif writes) rewritten to 10 and to 12 bits by
tests/torch_avif_depth.py: the port's load_image equals the JAX
package's (PIL 12.1: libavif 1.3.0 with dav1d 1.5.1) bit for bit, or
both raise. A file of its own beside tests/test_torch_formats_avif_hbd.py
so that the two run on different workers. One thread, no card."""

from pathlib import Path

import pytest
import torch

import torch_avif_depth
from test_torch_formats_avif import _same

torch.set_num_threads(1)
DATA = Path(__file__).resolve().parent / "data"
TEXTURES = sorted([*(DATA / "formats_avif" / "courtyard").glob("*.avif"),
                   *(DATA / "formats_avif_matrix" / "courtyard_ycgco").glob(
                       "*.avif")])


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("src", TEXTURES,
                         ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_courtyard_texture_at_depth_equals_pil(tmp_path, src, depth):
    _same(tmp_path, torch_avif_depth.to_depth(src.read_bytes(), depth))
