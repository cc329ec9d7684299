"""Cell runners, one module per traffic ``runner`` key."""
