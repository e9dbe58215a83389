"""Plain references the cells are held to: plain PyTorch, nothing of the
program imported."""
