"""Device-side helpers outside the physics step (the dense-pack readback)."""
