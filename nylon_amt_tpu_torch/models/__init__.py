"""The hFT model, its initialisation and weight conversion."""
