"""PyTorch + CUDA port of plainrenderer_tpu for one NVIDIA Hopper card.

Layout mirrors plainrenderer_tpu/ (render/, ops/, scene/, utils/,
assets/) so each module's counterpart is found by path. Plain tensor code
is PyTorch; every Pallas kernel of the ported path is a hand-written CUDA
kernel under csrc/, built at first use by native.py. The package imports
torch and numpy, never jax and nothing of plainrenderer_tpu.
"""

__version__ = "0.1.0"
