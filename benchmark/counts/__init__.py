"""Operations and bytes of the model's work, from shapes alone."""
