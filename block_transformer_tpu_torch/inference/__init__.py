"""Generation."""
