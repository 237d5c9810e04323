"""Model towers as ``nn.Module``s."""
