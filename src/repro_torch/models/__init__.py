"""Model families (the dense decoder LM so far) over plain dict params."""
