"""Device compute: batched Keccak-256.

* ``keccak_torch`` — the plain PyTorch sponge (25 int64 lanes per
  message, batch-vectorized); it runs on any device and is the CPU path
  and the card kernel's oracle.
* ``keccak_cuda`` + ``csrc/keccak.cu`` — kernels K1r (a batch of any
  lengths in one launch: one thread a message, or five for small
  batches) and K1f (rows of one length), the pad in registers.
* ``keccak`` — the dispatcher: CUDA tensors go to K1r or K1f, CPU
  tensors to the plain version.
* ``build`` — compiles every ``csrc/*.cu`` of the package with ``nvcc``
  at first use.
"""
