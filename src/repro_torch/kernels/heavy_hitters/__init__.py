"""Cell-owner decode kernel and the heavy-hitter analytics over planes."""
