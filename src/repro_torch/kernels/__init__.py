"""Hand-written CUDA kernels of the port, their plain versions, and the
dispatch rule (``ops``).  Call ``repro_torch.kernels.ops.flash_attention``,
``.paged_attention`` and ``.ssd_scan``; the kernel modules keep their own
names here."""
