"""Model zoo of the port: the dense decoder-only transformer."""
