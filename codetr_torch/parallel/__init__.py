"""Training: the Co-DINO losses and the train step."""
