"""Host-side build logic and the search cores."""
