"""Model code: config, layers, the decoder LM and its serve entry points."""
