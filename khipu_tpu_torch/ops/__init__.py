"""Device compute: batched Keccak-256.

* ``keccak_torch`` — the plain PyTorch sponge (25 int64 lanes per
  message, batch-vectorized); it runs on any device and is the CPU path
  and the card kernel's oracle.
* ``keccak_cuda`` + ``csrc/keccak.cu`` — kernel K1, one message per
  thread with the state in registers.
* ``keccak`` — the dispatcher: CUDA tensors go to K1, CPU tensors to the
  plain version.
* ``build`` — compiles every ``csrc/*.cu`` of the package with ``nvcc``
  at first use.
"""
