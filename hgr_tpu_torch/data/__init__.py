"""Device-side augmentation pipeline of the port."""
