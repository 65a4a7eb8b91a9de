"""Host <-> device conversions."""
