"""Command-line tools of the port: texconv (tools.texconv; texassemble,
texdiag and ddsview are still to port)."""
