"""models of the PyTorch port: the stencils, the MLP, the flagship
transformer and its sequence-parallel form, and the attention layouts
(ring, zigzag, Ulysses)."""
