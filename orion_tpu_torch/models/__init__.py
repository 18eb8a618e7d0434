"""Model configs and the linear-attention TransformerLM."""
