"""Models of the port (the decoder-only TransformerLM first)."""
