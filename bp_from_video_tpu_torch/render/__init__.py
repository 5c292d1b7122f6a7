"""Display: overlays, signal plots and HUD text composed on the card for
a whole stream batch, and the host window shell (``drawer.Drawer``)."""
