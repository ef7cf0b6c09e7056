"""Command-line tools of the port: texconv, texdiag, texassemble and
ddsview (tools.texconv, tools.texdiag, tools.texassemble, tools.ddsview),
each `main(argv, device=None)` on CUDA unless the caller names a device."""
