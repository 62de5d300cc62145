"""Training and evaluation data of the port: the dataset readers, the
host Loader, the device augmentation and the procedural synthetic pairs."""
