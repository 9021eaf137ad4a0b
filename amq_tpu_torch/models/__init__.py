"""Model configuration, layers, the Llama decoder and the stacked serving model."""
