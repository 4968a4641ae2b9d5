"""Orthoplane / tile consensus over RLE instances (host side).

Algorithmic parity with reference consensus.py:35-626 using a small
self-contained undirected graph (dict adjacency) instead of networkx:

1. box-screen candidate pairs across sources,
2. weight edges by RLE IoU / overlap,
3. group nodes into clusters at cluster_iou_thr (connected components of
   the strong-edge graph),
4. iteratively merge clusters around the most-connected cluster node,
5. per surviving cluster: pixel-vote the member RLEs,
6. merge residual overlapping instances.

The reference's tie-breaking rules are preserved (most-connected selection
by descending degree with stable insertion order; neighbor processing by
descending cluster size; second-neighbor edges are dropped during a pull —
matching the reference's effective behavior at consensus.py:133-140).
"""

from __future__ import annotations

import numpy as np

from empanada_torch.core.boxes import box_iou_pairs, merge_boxes
from empanada_torch.core.ranges import ranges_to_rle, vote_by_ranges, join_ranges
from empanada_torch.core.rle import (
    canonicalize_rle,
    merge_rles,
    rle_ioa,
    rle_iou,
    rle_pairwise_intersections,
)

MIN_OVERLAP = 100
MIN_IOU = 1e-2

__all__ = [
    "merge_instances",
    "merge_objects_from_trackers",
    "merge_semantic_from_trackers",
    "merge_objects_from_tiles",
    "merge_semantic_from_tiles",
]


class _Graph:
    """Minimal undirected graph: insertion-ordered nodes, edge attrs."""

    def __init__(self):
        self.nodes = {}   # node -> attr dict
        self.adj = {}     # node -> {neighbor: edge attr dict}
        self._seq = {}    # node -> insertion index (subgraph ordering)

    def add_node(self, n, **attrs):
        if n not in self.nodes:
            self.nodes[n] = {}
            self.adj[n] = {}
            self._seq[n] = len(self._seq)
        self.nodes[n].update(attrs)

    def _order(self, n):
        return self._seq[n]

    def add_edge(self, u, v, **attrs):
        self.add_node(u)
        self.add_node(v)
        self.adj[u][v] = attrs
        self.adj[v][u] = self.adj[u][v]

    def remove_edge(self, u, v):
        self.adj[u].pop(v, None)
        self.adj[v].pop(u, None)

    def remove_node(self, n):
        for m in list(self.adj[n]):
            del self.adj[m][n]
        del self.adj[n]
        del self.nodes[n]

    def has_edge(self, u, v):
        return v in self.adj.get(u, ())

    def edge(self, u, v):
        return self.adj[u][v]

    def neighbors(self, n):
        return list(self.adj[n])

    def degree(self, n):
        return len(self.adj[n])

    def n_edges(self):
        return sum(len(a) for a in self.adj.values()) // 2

    def connected_components(self):
        seen = set()
        for start in self.nodes:
            if start in seen:
                continue
            comp = []
            stack = [start]
            seen.add(start)
            while stack:
                u = stack.pop()
                comp.append(u)
                for v in self.adj[u]:
                    if v not in seen:
                        seen.add(v)
                        stack.append(v)
            yield set(comp)

    def subgraph(self, nodes):
        # iterate the REQUESTED nodes (in this graph's insertion order for
        # determinism), not all nodes: consensus calls this once per
        # connected component, and O(V) per call is O(V^2) at the
        # product's thousands of 3D instances
        sg = _Graph()
        nodes = set(nodes)
        if len(nodes) < len(self.nodes) // 4:
            ordered = sorted(nodes, key=lambda n: self._order(n))
        else:
            ordered = [n for n in self.nodes if n in nodes]
        for n in ordered:
            sg.add_node(n, **self.nodes[n])
        for n in sg.nodes:
            for m, attrs in self.adj[n].items():
                if m in nodes and not sg.has_edge(n, m):
                    sg.add_edge(n, m, **attrs)
        return sg


def _bounding_box_screening(boxes, source_indices):
    """Unique cross-source box pairs with non-trivial overlap
    (reference consensus.py:197-231)."""
    rows, cols, _, _ = box_iou_pairs(np.asarray(boxes))
    if len(rows) == 0:
        return np.zeros((0, 2), dtype=np.int64)
    pairs = np.stack([rows, cols], axis=1)
    src = np.asarray(source_indices)
    pairs = pairs[src[pairs[:, 0]] != src[pairs[:, 1]]]
    pairs = np.sort(pairs, axis=-1)
    if len(pairs) == 0:
        return pairs
    return np.unique(pairs, axis=0)


def _object_iou_graph(source_indices, object_boxes, object_starts,
                      object_runs):
    """Nodes = instances, edges = non-zero RLE overlap across sources.

    All box-screened pairs go through ONE batched native intersection
    call (core/rle.rle_pairwise_intersections): at the product's
    operating point (thousands of 3D instances across 3 axis trackers,
    reference consensus.py:348-469) per-pair Python/ctypes calls would
    be the dominant consensus cost."""
    graph = _Graph()
    for node_id in range(len(object_boxes)):
        graph.add_node(node_id, box=object_boxes[node_id],
                       starts=object_starts[node_id],
                       runs=object_runs[node_id])

    pairs = _bounding_box_screening(object_boxes, source_indices)
    if len(pairs) == 0:
        return graph
    inters = rle_pairwise_intersections(
        object_starts, object_runs, object_starts, object_runs,
        pairs[:, 0], pairs[:, 1])
    areas = np.array([int(np.sum(r)) for r in object_runs], dtype=np.int64)
    unions = areas[pairs[:, 0]] + areas[pairs[:, 1]] - inters
    keep = inters > 0
    ious = np.zeros(len(pairs), np.float64)
    ious[keep] = inters[keep] / unions[keep]
    for (r1, r2), iou, inter in zip(pairs[keep], ious[keep], inters[keep]):
        graph.add_edge(int(r1), int(r2), iou=float(iou), overlap=int(inter))
    return graph


def _create_graph_of_clusters(G, cluster_iou_thr):
    """Group nodes connected by edges with IoU > cluster_iou_thr
    (reference consensus.py:35-74)."""
    H = G.subgraph(G.nodes)
    for u in list(H.nodes):
        for v in list(H.adj[u]):
            if u < v and H.edge(u, v)["iou"] <= cluster_iou_thr:
                H.remove_edge(u, v)

    cluster_graph = _Graph()
    node_cluster = {}
    sizes = {}
    for i, cluster in enumerate(H.connected_components()):
        cluster_graph.add_node(i, cluster=cluster)
        sizes[i] = len(cluster)
        for n in cluster:
            node_cluster[n] = i

    # the cluster-pair "average edge" weight counts absent edges as 0,
    # so it equals (sum of existing cross-edges) / (|c1|*|c2|): one pass
    # over G's edges replaces the all-cluster-pairs x all-node-pairs
    # probing (O(C^2 * n1 * n2) -> O(E)); cluster pairs with no
    # connecting edge average to 0 and never pass the thresholds
    sums = {}
    for u in G.nodes:
        cu = node_cluster[u]
        for v, attrs in G.adj[u].items():
            if u < v and node_cluster[v] != cu:
                key = (min(cu, node_cluster[v]), max(cu, node_cluster[v]))
                acc = sums.setdefault(key, [0.0, 0.0])
                acc[0] += attrs["iou"]
                acc[1] += attrs["overlap"]
    # lexicographic pair order = the original combinations() insertion
    # order; edge insertion order is a tie-breaker in _merge_clusters
    for (n1, n2), (iou_sum, ov_sum) in sorted(sums.items()):
        denom = sizes[n1] * sizes[n2]
        iou_w = iou_sum / denom
        ov_w = ov_sum / denom
        if iou_w > MIN_IOU or ov_w > MIN_OVERLAP:
            cluster_graph.add_edge(n1, n2, iou=iou_w, overlap=ov_w)
    return cluster_graph


def _merge_clusters(G):
    """Iterative most-connected-first cluster merging
    (reference consensus.py:86-142, including its second-neighbor edge
    semantics)."""
    H = G.subgraph(G.nodes)

    while H.n_edges() > 0:
        most_connected = sorted(
            H.nodes, key=lambda x: H.degree(x), reverse=True)[0]
        neighbors = sorted(
            H.neighbors(most_connected),
            key=lambda x: len(H.nodes[x]["cluster"]), reverse=True)

        mc_cluster = H.nodes[most_connected]["cluster"]
        push_most_connected = (
            len(H.nodes[neighbors[0]]["cluster"]) > len(mc_cluster))

        if push_most_connected:
            # most-connected cluster is rejected as its own instance:
            # copy its members into every neighbor
            for neighbor in neighbors:
                H.nodes[neighbor]["cluster"] = \
                    H.nodes[neighbor]["cluster"] | mc_cluster
                H.remove_edge(most_connected, neighbor)
            H.remove_node(most_connected)
        else:
            # pull all neighbors into the most-connected cluster; their
            # remaining edges are dropped with them (reference behavior)
            for neighbor in neighbors:
                H.nodes[most_connected]["cluster"] = \
                    H.nodes[most_connected]["cluster"] | \
                    H.nodes[neighbor]["cluster"]
                H.remove_node(neighbor)
    return H


def _merge_instances(instances_dict):
    vals = list(instances_dict.values())
    if len(vals) < 2:
        return vals[0]
    box = vals[0]["box"]
    for attrs in vals[1:]:
        box = merge_boxes(box, attrs["box"])
    if len(vals) == 2:
        starts, runs = merge_rles(vals[0]["starts"], vals[0]["runs"],
                                  vals[1]["starts"], vals[1]["runs"])
    else:
        # one k-way join instead of chained pairwise unions (associative
        # — identical result; chained merges re-swept the accumulated
        # RLE per pair, quadratic in voxels at 3D instance sizes)
        ranges = []
        for attrs in vals:
            s = np.asarray(attrs["starts"], dtype=np.int64)
            r = np.asarray(attrs["runs"], dtype=np.int64)
            ranges.append(np.stack([s, s + r], axis=1))
        joined = ranges_to_rle(join_ranges(ranges))
        starts, runs = joined[:, 0], joined[:, 1]
    return dict(box=box, starts=starts, runs=runs)


merge_instances = _merge_instances  # public alias (reference consensus.py:305)


def _merge_overlapping(cluster_instances):
    """Merge instances with non-trivial mutual overlap
    (reference consensus.py:166-195).

    Pairs are box-screened, then all surviving pairs go through ONE
    batched native intersection call (box-disjoint pairs have zero
    voxel overlap, so screening cannot change the result)."""
    if len(cluster_instances) < 2:
        return list(cluster_instances.values())

    ids = list(cluster_instances.keys())
    boxes = np.asarray([cluster_instances[i]["box"] for i in ids],
                       dtype=np.int64)
    starts = [np.asarray(cluster_instances[i]["starts"], np.int64)
              for i in ids]
    runs = [np.asarray(cluster_instances[i]["runs"], np.int64)
            for i in ids]

    g = _Graph()
    for i in ids:
        g.add_node(i)
    rows, cols, _, _ = box_iou_pairs(boxes)
    if len(rows):
        sel = rows < cols  # unique unordered pairs (self mode emits both)
        rows, cols = rows[sel], cols[sel]
    if len(rows):
        inters = rle_pairwise_intersections(starts, runs, starts, runs,
                                            rows, cols)
        areas = np.array([int(np.sum(r)) for r in runs], dtype=np.float64)
        unions = areas[rows] + areas[cols] - inters
        ious = np.where(unions > 0, inters / unions, 0.0)
        for r, c, iou, inter in zip(rows, cols, ious, inters):
            if iou > MIN_IOU or inter > MIN_OVERLAP:
                g.add_edge(ids[int(r)], ids[int(c)])

    merged = []
    for comp in g.connected_components():
        comp_instances = {k: v for k, v in cluster_instances.items()
                          if k in comp}
        merged.append(_merge_instances(comp_instances))
    return merged


def _unpack_trackers(object_trackers):
    tracker_indices, labels, boxes, starts, runs = [], [], [], [], []
    for tr_index, tr in enumerate(object_trackers):
        for instance_id, attrs in tr.instances.items():
            tracker_indices.append(tr_index)
            labels.append(int(instance_id))
            boxes.append(attrs["box"])
            # foreign trackers (the reference's axis trackers emit
            # UNSORTED runs) are canonicalized; ours pass through free
            s, r = canonicalize_rle(attrs["starts"], attrs["runs"])
            starts.append(s)
            runs.append(r)
    return (np.array(tracker_indices), np.array(labels), np.array(boxes),
            starts, runs)


def merge_objects_from_trackers(object_trackers, pixel_vote_thr=2,
                                cluster_iou_thr=0.75, bypass=False):
    """Instance consensus across axis trackers
    (reference consensus.py:348-469)."""
    n_votes = len(object_trackers)
    min_cluster_size = 1 if bypass else (n_votes // 2) + 1
    if pixel_vote_thr < min_cluster_size:
        cluster_iou_thr = 0

    tracker_indices, _, object_boxes, object_starts, object_runs = \
        _unpack_trackers(object_trackers)
    if len(object_boxes) == 0:
        return {}

    graph = _object_iou_graph(tracker_indices, object_boxes,
                              object_starts, object_runs)

    instance_id = 1
    instances = {}
    for comp in graph.connected_components():
        if len(comp) < min_cluster_size:
            continue

        cluster_graph = _create_graph_of_clusters(
            graph.subgraph(comp), cluster_iou_thr)
        cluster_graph = _merge_clusters(cluster_graph)

        cluster_id = 1
        cluster_instances = {}
        for node in cluster_graph.nodes:
            cluster = list(cluster_graph.nodes[node]["cluster"])
            if len(cluster) < min_cluster_size:
                continue

            merged_box = graph.nodes[cluster[0]]["box"]
            for node_id in cluster[1:]:
                merged_box = merge_boxes(merged_box,
                                         graph.nodes[node_id]["box"])

            all_ranges = [
                np.stack([graph.nodes[n]["starts"],
                          graph.nodes[n]["starts"] + graph.nodes[n]["runs"]],
                         axis=1)
                for n in cluster
            ]
            voted = vote_by_ranges(all_ranges, pixel_vote_thr)
            if len(voted) > 0:
                cluster_instances[cluster_id] = {
                    "box": tuple(int(b) for b in merged_box),
                    "starts": voted[:, 0],
                    "runs": voted[:, 1] - voted[:, 0],
                }
                cluster_id += 1

        for attrs in _merge_overlapping(cluster_instances):
            instances[instance_id] = attrs
            instance_id += 1

    return instances


def merge_semantic_from_trackers(semantic_trackers, pixel_vote_thr=2):
    """Semantic consensus: a pure pixel vote
    (reference consensus.py:289-346)."""
    boxes, starts, runs = [], [], []
    for tr in semantic_trackers:
        assert len(tr.instances) <= 1, "Semantic classes only have 1 label!"
        for attrs in tr.instances.values():
            boxes.append(attrs["box"])
            starts.append(np.asarray(attrs["starts"], dtype=np.int64))
            runs.append(np.asarray(attrs["runs"], dtype=np.int64))

    if not boxes:
        return {}

    merged_box = boxes[0]
    for box in boxes[1:]:
        merged_box = merge_boxes(merged_box, box)

    seg_ranges = [np.stack([s, s + r], axis=1) for s, r in zip(starts, runs)]
    voted = vote_by_ranges(seg_ranges, pixel_vote_thr)
    if len(voted) == 0:
        return {}
    return {1: {"box": merged_box, "starts": voted[:, 0],
                "runs": voted[:, 1] - voted[:, 0]}}


def _unpack_tiles(tiles):
    tile_indices, labels, boxes, starts, runs = [], [], [], [], []
    for tile_idx, tile_instances in enumerate(tiles):
        for instance_id, attrs in tile_instances.items():
            tile_indices.append(tile_idx)
            labels.append(int(instance_id))
            boxes.append(attrs["box"])
            starts.append(np.asarray(attrs["starts"], dtype=np.int64))
            runs.append(np.asarray(attrs["runs"], dtype=np.int64))
    return (np.array(tile_indices), np.array(labels), np.array(boxes),
            starts, runs)


def merge_semantic_from_tiles(tiles):
    """Union-join semantic RLEs from overlapping tiles
    (reference consensus.py:471-524)."""
    label_id = None
    boxes, starts, runs = [], [], []
    for tile_instances in tiles:
        for instance_id, attrs in tile_instances.items():
            if label_id is None:
                label_id = instance_id
            boxes.append(attrs["box"])
            starts.append(np.asarray(attrs["starts"], dtype=np.int64))
            runs.append(np.asarray(attrs["runs"], dtype=np.int64))

    if not boxes:
        return {}

    merged_box = boxes[0]
    for box in boxes[1:]:
        merged_box = merge_boxes(merged_box, box)

    seg_ranges = [np.stack([s, s + r], axis=1) for s, r in zip(starts, runs)]
    joined = join_ranges(seg_ranges)
    return {label_id: {"box": merged_box, "starts": joined[:, 0],
                       "runs": joined[:, 1] - joined[:, 0]}}


def merge_objects_from_tiles(tiles, overlap_rle=None):
    """Merge instance RLEs from overlapping 2D tiles; single-tile objects
    mostly inside the overlap region are dropped as likely false positives
    (reference consensus.py:526-626)."""
    tile_indices, object_labels, object_boxes, object_starts, object_runs = \
        _unpack_tiles(tiles)
    if len(object_boxes) == 0:
        return {}

    graph = _object_iou_graph(tile_indices, object_boxes,
                              object_starts, object_runs)

    if overlap_rle is not None:
        overlap_starts, overlap_runs = overlap_rle

    instance_id = int(np.min(object_labels))
    instances = {}
    for cluster in graph.connected_components():
        cluster = list(cluster)
        merged_box = graph.nodes[cluster[0]]["box"]
        for node_id in cluster[1:]:
            merged_box = merge_boxes(merged_box, graph.nodes[node_id]["box"])

        all_ranges = [
            np.stack([graph.nodes[n]["starts"],
                      graph.nodes[n]["starts"] + graph.nodes[n]["runs"]],
                     axis=1)
            for n in cluster
        ]
        voted = join_ranges(all_ranges)

        if overlap_rle is not None and len(cluster) < 2 and len(voted) > 0:
            voted_rle = ranges_to_rle(voted)
            ov_ioa = rle_ioa(overlap_starts, overlap_runs,
                             voted_rle[:, 0], voted_rle[:, 1])
            if ov_ioa > 0.1:
                voted = []

        if len(voted) > 0:
            instances[instance_id] = {
                "box": tuple(int(b) for b in merged_box),
                "starts": voted[:, 0],
                "runs": voted[:, 1] - voted[:, 0],
            }
            instance_id += 1

    return instances
