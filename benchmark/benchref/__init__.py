"""Plain references of psxavenc's encoders: plain PyTorch, no import of
the program under test or of JAX."""
