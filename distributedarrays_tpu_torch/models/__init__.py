"""models of the PyTorch port: the stencils, the MLP, the flagship
transformer and its sequence-parallel form, the attention layouts (ring,
zigzag, Ulysses), the pipeline, the expert-parallel MoE, k-means and the
Monte-Carlo estimators."""
