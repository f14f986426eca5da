"""Supervised training of CoTracker3 on one GPU (port of cotracker_tpu/training):
losses, the train step and optimizer, the data loader and the trainer loop."""
