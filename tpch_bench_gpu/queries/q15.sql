SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
 FROM supplier, (SELECT l_suppkey AS supplier_no,
   SUM(l_extendedprice * (1 - l_discount)) AS total_revenue FROM lineitem
   WHERE l_shipdate >= '1993-05-13' AND l_shipdate < '1993-08-13'
   GROUP BY l_suppkey) AS revenue
 WHERE s_suppkey = supplier_no AND total_revenue =
   (SELECT max(SUM_REV) FROM (SELECT SUM(l_extendedprice * (1 - l_discount))
    AS SUM_REV FROM lineitem WHERE l_shipdate >= '1993-05-13'
    AND l_shipdate < '1993-08-13' GROUP BY l_suppkey))
 ORDER BY s_suppkey
