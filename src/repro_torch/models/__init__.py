"""Model layers for serving: RMSNorm, RoPE, SwiGLU, GQA attention through
K5, the transformer assembly, and the reference-parameter converter."""
