"""Cell modules, one per traffic kind (a traffic file's "kind")."""
