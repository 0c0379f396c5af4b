"""bronko-tpu-torch: the bronko-tpu variant caller on PyTorch and CUDA.

A port of `bronko_tpu` (JAX on a TPU) to PyTorch on one NVIDIA Hopper
card. The JAX package stays the reference: every module here takes the
name of its counterpart there, and the tests hold each one against it.
The host modules (FASTA/FASTQ IO, the native C++ reader and counter, the
index builder and store, the noise scan, the caller and the writers) are
this package's own copies of the JAX package's, under the same names; it
imports nothing of `bronko_tpu`.

Device code takes an explicit `torch.device`; nothing here reads a global
device or sets global configuration. 64-bit k-mer words and bucket ids are
held as int64 tensors carrying the uint64 bit pattern.
"""

from bronko_tpu_torch.consts import BRONKO_TPU_VERSION as __version__  # noqa: F401
