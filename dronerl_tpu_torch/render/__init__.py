"""Host-side visualization: the PIL frame renderer and video encoding
(PIL is imported where a frame is drawn)."""
