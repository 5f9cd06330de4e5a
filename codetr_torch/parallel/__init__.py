"""Training: the Co-DINO losses, the train step on one device and sharded
over a ("dp", "tp") mesh, the sharded forward and the multi-device dry run."""
