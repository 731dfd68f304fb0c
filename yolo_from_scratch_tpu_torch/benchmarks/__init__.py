"""Counterparts of the JAX repository's `benchmarks/` scripts that drive a
hand-written kernel: the conv-backward prototypes (`bwdproto`, K3 and K4)
and the bottleneck-chain backward (`blockbwd`, K5). Run each as a module,
`python -m yolo_from_scratch_tpu_torch.benchmarks.bwdproto`."""
