"""Launch tooling of the port: meshes, (architecture x shape) cells and the
dry-run that counts each cell's FLOPs and bytes on the ``meta`` device."""
