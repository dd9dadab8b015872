"""Models of the port: the decoder-only TransformerLM and the ResNet
family."""
