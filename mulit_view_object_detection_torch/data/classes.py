"""InteriorNet class taxonomy: NYU-40 -> 22 selected classes
(samples/interior/classes.py:1-32, including the desk->table,
bookshelf->shelves and refridgerator->refrigerator merges).

A copy of `mulit_view_object_detection_tpu/data/classes.py`: the port
imports nothing of the JAX package, not even a module without jax."""

NYU40_CLASS_NAMES = [
    "BG", "wall", "floor", "cabinet", "bed", "chair", "sofa",
    "table", "door", "window", "bookshelf", "picture", "counter",
    "blinds", "desk", "shelves", "curtain", "dresser", "pillow",
    "mirror", "floor", "clothes", "ceiling", "books", "refridgerator",
    "television", "paper", "towel", "shower", "box", "whiteboard",
    "person", "night", "toilet", "sink", "lamp", "bathtub", "bag",
    "otherstructure", "otherfurniture", "otherprop",
]

SELECTED_CLASSES = [
    "BG", "cabinet", "bed", "chair", "sofa", "table",
    "picture", "blinds", "shelves", "dresser", "pillow",
    "mirror", "clothes", "books", "refrigerator", "television", "paper",
    "towel", "toilet", "sink", "lamp", "bathtub", "bag",
]

NYU40_TO_SELECTED = {}
SELECTED_CLASS_LIST = []
for _i, _name in enumerate(NYU40_CLASS_NAMES):
    if _name in SELECTED_CLASSES:
        NYU40_TO_SELECTED[_i] = SELECTED_CLASSES.index(_name)
        SELECTED_CLASS_LIST.append(_i)
    else:
        NYU40_TO_SELECTED[_i] = 0
# manual merges (classes.py:27-32)
NYU40_TO_SELECTED[NYU40_CLASS_NAMES.index("desk")] = \
    SELECTED_CLASSES.index("table")
NYU40_TO_SELECTED[NYU40_CLASS_NAMES.index("bookshelf")] = \
    SELECTED_CLASSES.index("shelves")
NYU40_TO_SELECTED[NYU40_CLASS_NAMES.index("refridgerator")] = \
    SELECTED_CLASSES.index("refrigerator")
SELECTED_CLASS_LIST.append(NYU40_CLASS_NAMES.index("desk"))
SELECTED_CLASS_LIST.append(NYU40_CLASS_NAMES.index("bookshelf"))
SELECTED_CLASS_LIST.append(NYU40_CLASS_NAMES.index("refridgerator"))

NUM_SELECTED_CLASSES = len(SELECTED_CLASSES)  # 23 incl. background
