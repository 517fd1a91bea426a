"""Runtime layer: the public block facade over the device kernels, the
native host engine and the fragment prescan."""
