"""Model assembly of the port (dense family): layers and the decoder LM."""
