SELECT regexp_replace("Referer", '^https?://([^/]+)/.*$', '\1') AS k,
       AVG(length("Referer")) AS l, COUNT(*) AS c, MIN("Referer") AS mn
FROM hits WHERE "Referer" <> ''
GROUP BY k HAVING COUNT(*) > 10 ORDER BY l DESC LIMIT 25
