"""Model layers for serving and training: RMSNorm, RoPE, SwiGLU, GQA
attention through K5, the transformer assembly, and the reference-parameter
converter."""
