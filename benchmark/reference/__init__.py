"""The plain reference: PyTorch and NumPy only.  It imports nothing of
the port and takes nothing the port made; it works out again, from the
generated inputs, whatever the port derives from them."""
