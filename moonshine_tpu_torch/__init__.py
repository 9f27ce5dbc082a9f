"""moonshine_tpu_torch — the moonshine path tracer in PyTorch, for CUDA.

A port of `moonshine_tpu` (the JAX/Pallas package beside it, which stays
the reference). Same subpackages and public names; plain functions on
tensors; scenes are built on the host with numpy and land on the device
given to `World.build(device=...)` (the card unless told otherwise). The
wide-BVH traversal kernels are hand-written CUDA (`csrc/traverse.cu`
packet kernels, `csrc/treelet.cu` treelet-scheduled ones, built with nvcc
at first use); every other step of the render is torch ops.

This package never imports jax nor anything of the JAX package: the
machine with the card has no jax, so scenes are built here in numpy.

Subpackages
-----------
core        RNG, warp mappings, reflection frames, alias tables
accel       Karras / SAH + wide-BVH build, CUDA packet and treelet traversal
bsdf        Lambert / StandardPBR(GGX) / mirror / glass, branchless dispatch
lights      equal-area environment maps, emissive mesh lights
scene       scene types, material atlas, World -> DeviceScene, procedural
integrator  batched path tracer (NEE + MIS + russian roulette)
render      camera, sensor, render_sample / render_spp / render
io          scanline EXR reading (the committed golden images)
"""

__version__ = "0.1.0"
