"""PyTorch/CUDA port of frcnn_tpu: batched two-stage detection and its
joint training on NVIDIA Hopper, with hand-written CUDA kernels where the
JAX package has Pallas kernels. The JAX package stays the reference; this
package imports none of it."""
